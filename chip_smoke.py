"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), torch / CUDA versions;
2. build the fused-matcher kernel (csrc/fused_match.cu) with nvcc;
3. the kernel against its plain PyTorch version on synthetic inputs at the
   main path's three shapes (dense windows: 90% of the rows active) and on
   edge cases that reach the kernel's boundaries (all rows masked, no
   valid keypoint, radius-0 windows hitting exact pixels, ties across
   keypoint tiles, strips and ring chunks, ragged sizes, more keypoints
   than stay resident in shared memory): exact equality, and the dense
   shapes timed beside the plain version, with the kernel's own count of
   the keypoint tiles it walked and sent to the binary tensor cores (its
   counting build; every other launch takes the build without counters);
4. the main path at full width: a 640x480 RGB-D camera, 1000 ORB
   keypoints over 8 levels, 256 keyframes / 32768 landmarks, 40 rendered
   frames with ground truth, driven as 7-10 are (drive_path). Checks
   tracking state, keyframe and landmark counts, ATE < 0.05 m, that every
   matcher call launched the kernel and the launches by row count;
5. the kernel against its plain version on every input the main path
   gave it (all calls, exact), and at each call site its last call timed
   beside the plain version, a bf16 bit-plane matmul yardstick and the
   card's bound. Device times come
   from torch.profiler's kernel records, with the number of records
   summed; one call's time between CUDA events (which adds the launch's
   host time) is kept beside them. The inputs timed here are saved to
   build/fused_match_inputs.pt and timed in a fresh process (see
   time_in_child), which compare_fused_match.py reads too;
6. a torch.profiler pass over 4 frames of a fresh run, around its second
   keyframe chain: device operations per frame and per stage, device
   busy share, the heaviest kernels;
7. the monocular path: the JAX monocular test's sequence (seed 42) at
   its own configuration (mono_320: 320x240, 600 keypoints over 4
   levels, 16 frames at 0.08 m a frame, K = 32, L = 8192): TRACKING, >= 10
   frames in the trajectory, Sim3-aligned ATE < 0.08 m; the same sequence
   at the main path's width (mono: 40 frames): TRACKING, >= 30 frames in
   the trajectory, Sim3-aligned ATE < 0.2 m (MONO_FULL_WIDTH_ATE; the JAX
   System's CPU ATE of that sequence, JAX_CPU_MONO_ATE, printed beside
   the card's, ROADMAP C45); the seed-0 and seed-1 sequences (8
   frames each) reported (the JAX System's CPU runs are
   tests/test_torch_mono.py's slow tests'); driven with fixed summation
   orders (deterministic()), so that a run gives one result;
8. the stereo path: 40 rendered pairs, 0.1 m baseline; TRACKING, tracked
   >= 39, > 200 landmarks, ATE < 0.06 m; (b, after 10) the same path at
   two dataset cameras, each from its YAML (DATASET_CAMERAS): EuRoC's
   752x480 (1000 keypoints, 1,032 slots; the rendered pairs are
   rectified, so its StereoRectifier node is left out) and KITTI
   odometry's 1241x376 (2000 keypoints, 2,040 slots, a 0.537 m baseline),
   24 pairs of phase 8's scene each (plane widened to the wider views),
   K = 256, L = 32768: TRACKING, tracked >= 23, > 200 landmarks, ATE <
   0.06 m, the matcher checks of phase 4, peak device memory; the KITTI
   path's last stage-1 and stage-2 inputs timed with phase 11's;
9. relocalization, two blackouts (LOST after two black frames, TRACKING
   after a frame shown again, the relocalizer run on each lost frame,
   the centre within 0.08 m of its ground truth): tests/test_loop_system
   .py's (frame 4 of 8 again), and a kidnapped camera only the
   relocalizer recovers (frame 4 again, turned upside down; >= 1
   relocalization);
10. growth: the RGB-D sequence from 4 keyframes / 2048 landmarks, which
   must double both and keep ATE < 0.05 m;
11. loop closing: tests/test_loop_system.py's organic out-and-back (24
   frames out and 24 back at 0.4 m a frame), a rigid drift injected into
   the later half of the map after the outbound leg, the return leg fed
   with loop closing on (the System's default): at least one loop closed,
   the deferred global BA merged, TRACKING, the last keyframe within
   0.35 m of its ground truth, and the loop fix's fuse call (its own call
   site, loop_fuse) with active rows; its input timed like phase 5's.
   The fed frame of each loop-fix phase of the return leg and its
   largest feed time over the median are printed; validate and correct
   must run on different fed frames (tests/test_loop_latency.py's
   structural half; its 25x latency bound is reported, not gated);
   Each of 4, 7-12 and 18 runs at the main path's width (8 (b) at its
   own cameras; but the gated
   monocular cases of phases 7 and 12) with the kernel's
   counts set to 0 before it and read after, and fails unless every
   matcher call of the path (three per track_frame, the relocalizer's
   candidates included, one per keyframe chain, one per loop fix)
   launched the kernel, by the wrapper's launch counter read around each
   call; it prints frames/s, stage medians and the card line, and holds
   the kernel against its plain version on every matcher input of the
   path (exact);
12. points + lines + planes (plp_paths): RGB-D with lines and instance
   masks on the grid-textured scene, 24 frames (TRACKING, ATE < 0.06 m,
   >= 4 lines with > 60% of their endpoints within 0.4 m of the scene's
   planes, >= 1 plane, each |n_z| > 0.98 with an offset within 0.3 m of
   3.5 or 6, > 30 plane-owned landmarks, every line and plane stage run),
   then profiled like phase 6 (over two frames) and one frame's host
   syncs counted;
   monocular + lines (gated at the JAX test's 320x240, reported at full
   width over 8 frames; the JAX System's full-width result on the CPU is
   tests/test_torch_plp_system.py's slow test's) and stereo + lines (TRACKING, >= 4 lines, > 60% near the
   planes, ATE < 0.06 m, > 200 landmarks), with the matcher checks of
   phases 4 and 7-11;
13. whether torch.linalg.svd / eigh / det on the card make the host wait;
14. fisheye RGB-D (fisheye_path): a Kannala-Brandt 640x480 camera, 24
   frames of the port's fisheye renderer (TRACKING, ATE < 0.06 m), with
   the matcher checks of phases 4 and 7-12; then profiled like phase 6;
15. equirectangular monocular (equirect_path): OpenVSLAM's aist
   configuration (1920x960, 2000 keypoints, its mask rectangles), 16
   frames of the port's cube room (initialized, TRACKING, Sim3 ATE <
   0.10 m). Its matches take the masked matchers with the u window
   wrapped, as the JAX package routes the sphere: 0 kernel launches by
   design, and every masked-matcher call equal to the same call on the
   CPU (PlainRecorder); then profiled;
16. the fisheye stereo rectifier on the card against the CPU (maps within
   1e-3 px, images within 1e-3 of 255), one pair timed;
17. the I/O and viewer surfaces (io_paths): (a) yaml, msgpack, cv2 and
   PIL import, else the missing ones are named; (b) native/ built with
   make if its library is absent; (c) the CLI (``run.main(["tum_rgbd",
   ...])``, in this process, inside the kernel recorder) on a TUM RGB-D
   layout of phase 4's 40 frames written to disk (PNG images, uint16
   depth at 5000 per metre, groundtruth.txt, an OpenCV-dialect YAML):
   every matcher call launched the kernel and equals the plain twin,
   TRACKING, >= 2 keyframes, ATE of the written trajectory < 0.05 m, the
   HTML export written; the snapshot's save and load timed, its size;
   (d) the CLI localizing 10 frames from frame 15 against (c)'s map
   (``--map-db-in``), the first turned 180 degrees as in phase 9 (b): the
   first frame relocalized, TRACKING, no keyframe added, the last frame
   localized, centres within 0.08 m, the kernel on every call; (e) 24 frames
   through the library with autosave every 2 keyframes, the native
   publisher and a loopback TCP client, the live viewer polled at
   /map.json (HTTP 200, the landmark and dense counts) and the dense
   cloud, each gated; phase 12 (a)'s host syncs per frame gated at 29;
18. the landmark-sharded global BA (mesh_paths): (a) phase 11's loop path
   with the System's ``loop_closer.mesh`` set to 4 landmark shards on
   cuda:0 (and, with several visible cards, to a mesh over all of them):
   phase 11's gates and kernel checks, each deferred global BA merged
   through the mesh branch (one ``gba.chunk``, one mesh solve), the host
   syncs of each mesh solve and the peak device memory printed; (b) the
   dense mesh solve on the map (a) leaves against the single-device solve
   (same state and anchor): poses within 5e-3, landmarks within 2e-2,
   both timed; (c) the PCG mesh route on testing/large_map.py's K = 1024
   chain map with 2 cm of pose noise: it must move the poses, and agree
   at the same bounds with the single-device PCG on the card (the chain
   preconditioner's blocks at the chain positions, ROADMAP C42) and with
   the same mesh solve on 4 CPU shards, and with the map in float64 agree
   with the single-device PCG within 1e-8 (the float32 gap is summation
   order, ROADMAP C44); (b) and (c) both timed and each traced once per
   solve under torch.profiler;
19. the public functions no path calls (public_ops): perspective
   reproject_stereo, hamming mutual_best_matches (with and without the
   ratio test), image build_pyramid, orb ic_angles and
   brief_descriptors, triangulation check_triangulation, each on the
   card against the same call on the CPU at the main path's shapes:
   masks, indices and descriptors equal, floats within 1e-5 relative;
   the frontend's arithmetic on the main path's first frame (ROADMAP
   C8): the pyramid, the atlas, both orders of the moment maps and of
   the blur bit-equal, ic_angles within 2 ulp (the devices' own atan2f:
   glibc's on the CPU, CUDA's on the card; the largest gap printed), the
   extractor's slots equal, its angles within 2 ulp, the share of equal
   descriptors printed; (b) knob_checks: public parameters at
   non-default values on the card against the CPU (essential_ransac
   num_hypotheses=64, sim3_ransac fix_scale=True, match_stereo window=7
   patch=3, Relocalizer min_inliers=30 on phase 4's map); (c)
   dataset_frontends: the frontend's pyramid and atlas bit-equal,
   ic_angles within 2 ulp and the extractor's slots equal (angles within
   2 ulp, the share of equal descriptors printed) on the first left frame
   of each of phase 8 (b)'s cameras; (d) linalg_checks: the factorizations
   of ops/linalg (svd, eigh, cho_factor / cho_solve, block_cholesky_solve,
   inv, solve, det3), on the card (torch.linalg, cuSOLVER) against the
   CPU (scipy's LAPACK, the routines XLA:CPU calls) at the call sites'
   shapes: values within 1e-4 of the CPU's largest, singular and eigen
   vectors up to sign (cuSOLVER picks its own), a failed Cholesky NaN on
   both; (e) init_ba_checks: the monocular two-view init's BA (640x480,
   seed 42) on the card (the PyTorch iteration) against the CPU
   (ops/ba_cpu's C source, XLA:CPU's arithmetic): poses within 1e-4,
   points within 1e-3 m; match_stereo at phase 8 (b)'s two cameras, card
   against CPU: masks equal, x_right within 1e-3 px, depth within 1e-4
   relative; (f) chain_ba_checks: the monocular keyframe chain's local
   BA (640x480, seed 42, the first chain after the init, 32 window
   cameras) on the card (the PyTorch iteration) against the CPU's C
   source: poses within 1e-4, points within 1e-3 m; (g)
   rgbd_chain_ba_checks: the same for the main path's RGB-D System's
   first chain (its stereo rows from the depth: the C source's 3-row
   arithmetic), with (f)'s bounds and the card's sums in fixed orders;
20. one JSON line with each path's numbers, one with the rectifier's, one
   with phase 19's, one with every kernel's numbers (launches per path
   added), the card line, and the result line ``{"ok": true, "device":
   {...}}`` last.

It needs a CUDA device and the repository around it; it never falls back
to the CPU and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, int8 tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
WINDOW_TEST_OPS = 9  # per (active row, keypoint): 3 subtractions, 3 abs, 3 compares
DIST_OPS = 2 * 256   # per in-window pair: a 256-long ±1 dot product (multiply + add)

CALL_SITES = {
    "track_stage1": "tracker.py stage 1 (narrow + wide windows, previous frame's landmarks)",
    "track_stage2": "tracker.py stage 2 (local map)",
    "fuse": "mapper.fuse_into_keyframe (every landmark slot)",
    "loop_fuse": "the loop fix's mapper.fuse_into_keyframe (the candidate keyframe's landmarks "
                 "into the current keyframe; system.py _advance_pending_fix)",
}
REPLACES = "structure_plp_slam_tpu/ops/pallas_matching.py:42"
SOURCE = "structure_plp_slam_tpu_torch/csrc/fused_match.cu"
NUM_FRAMES = 40
REPORTED_MONO_FRAMES = 8  # phase 7's reported seeds (0 and 1)
FISHEYE_FRAMES = 24  # phase 14
# Phase 7's bound on the full-width monocular run's Sim3 ATE (m): on the CPU
# the JAX System and the port both end at 0.115389 (at any torch thread
# count, with the same keyframes; ROADMAP C18, C45), on the card the port's
# float order is its own; 0.2 holds a run that tracks as the reference does
# and fails one that drifts.
MONO_FULL_WIDTH_ATE = 0.2
# The JAX System's Sim3 ATE (m) of phase 7's full-width sequence on the
# CPU, as PERF.md records it from tests/test_torch_mono.py's slow run
# (32 keyframes, 8192 landmarks, loop closing off); printed, not computed:
# this script imports nothing of JAX.
JAX_CPU_MONO_ATE = 0.115389
PLP_FRAMES = 24    # phase 12 (a)
LINE_FRAMES = 16   # phase 12 (b) and (c)
REPORTED_LINE_FRAMES = 8  # phase 12 (b)'s reported full-width run
PLP_KF_INTERVAL = 2
# Phase 12 (a)'s count since the frontend's constants stay on the card
# (61 before; PERF.md §5).
MAX_PLP_SYNCS = 29
REPS = 20  # calls per profiler session
# The inputs phase 5 times, saved on the host (for compare_fused_match.py too).
INPUTS = Path(__file__).resolve().parent / "build" / "fused_match_inputs.pt"
# Which design of the kernel ran: strips with active-row compaction,
# shared-memory-resident keypoints, distances on the binary tensor cores.
DESIGN = "compacted-strips/resident-keypoints/b1-mma"


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synthetic_inputs(rng, L, N, kind="dense"):
    """Landmark / keypoint rows in the kernel's layout, from a numpy seed:
    90% of the rows active with 50-400 px windows (a dense worst case),
    changed as ``kind`` says."""
    desc_lm = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    desc_kp = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    for i in range(0, N, 3):  # near-duplicates so real matches exist
        d = desc_lm[(i * 7) % L].copy()
        d[0] ^= 0x3
        desc_kp[i] = d
    lm_meta = np.stack([
        rng.uniform(0, 600, L), rng.uniform(0, 600, L),
        np.where(rng.uniform(size=L) < 0.9, rng.uniform(50, 400, L), -1.0),
        rng.integers(0, 4, L),
    ], -1).astype(np.float32)
    kp_meta = np.stack([
        rng.uniform(0, 600, N), rng.uniform(0, 600, N),
        np.where(rng.uniform(size=N) < 0.95, rng.integers(0, 4, N), 1e9),
    ], -1).astype(np.float32)
    if kind in ("ties", "ties_tiles"):  # every keypoint in every window
        kp_meta[:, :2] = 300.0
        kp_meta[:, 2] = 1.0
        lm_meta[:, 2] = 1000.0
        lm_meta[:, 3] = 1.0
    if kind == "ties":  # a few distinct descriptors: equal distances everywhere
        desc_kp = desc_kp[rng.integers(0, 4, N)]
    elif kind == "ties_tiles":  # each row's copy in three tiles (N >= 3 L)
        for off in (0, L, 2 * L):
            desc_kp[off:off + L] = desc_lm
    elif kind == "masked":
        lm_meta[:, 2] = -1.0
    elif kind == "kp_invalid":
        kp_meta[:, 2] = 1e9
    elif kind == "radius0":  # integer pixels; radius 0, -0.0, NaN or inactive
        kp_meta[:, :2] = rng.integers(0, 24, (N, 2))
        kp_meta[:, 2] = rng.integers(0, 2, N)
        lm_meta[:, :2] = rng.integers(0, 24, (L, 2))
        lm_meta[:, 3] = rng.integers(0, 2, L)
        lm_meta[:, 2] = rng.choice(np.array([0.0, -0.0, np.nan, -1.0], np.float32), L,
                                   p=[0.6, 0.2, 0.1, 0.1])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return (dev(desc_lm.view(np.int32)), dev(lm_meta), dev(desc_kp.view(np.int32)),
            dev(kp_meta))


def check_exact(fm, args, label):
    """Kernel output == plain output on every row; returns max |diff|."""
    k = fm.fused_match(*args)
    torch.cuda.synchronize()
    p = fm.fused_match_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("best", "second", "idx"), k, p):
        if not torch.equal(a, b.to(a.dtype)):
            bad = int((a != b.to(a.dtype)).sum())
            raise AssertionError(f"{label}: kernel {name} differs from plain on {bad} rows")
    return float(max((a.to(torch.float32) - b.to(torch.float32)).abs().max().item()
                     for a, b in zip(k, p)))


def time_ms(fn, reps=30, warmup=3):
    """Median milliseconds of one call of ``fn`` between two CUDA events:
    device time plus whatever host time the device waits for the launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps=REPS, warmup=3, attempts=3):
    """Device milliseconds per call of ``fn`` and the number of records
    behind them: the durations of the kernels it ran, summed, as
    torch.profiler (CUPTI) records them, averaged over ``reps`` calls. No
    host time. A session whose record count is not a whole multiple of
    ``reps`` (none at all, seen on a process's first session, or a record
    lost) is run again; after ``attempts`` the last one counts, and its
    record count shows it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels and len(kernels) % reps == 0:
            break
    if not kernels:
        raise RuntimeError(f"the profiler recorded no device activity in {attempts} sessions")
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3, len(kernels)


def time_in_turns(first, second, args):
    """Two ``(name, fn)`` on the same inputs, timed in turns (first,
    second, second, first); each keeps its better reading: ``<name>_ms``
    device time with ``<name>_records`` behind it (a reading with a whole
    multiple of REPS records beats a lower one that lost records), and
    ``<name>_call_ms``, one call's event time."""
    t, rank = {}, {}
    for name, fn in (first, second, second, first):
        ms, records = device_ms(lambda: fn(*args))
        r = (records % REPS != 0, ms)
        if r < rank.get(name, (True, float("inf"))):
            rank[name] = r
            t[f"{name}_ms"], t[f"{name}_records"] = ms, records
        t[f"{name}_call_ms"] = min(t.get(f"{name}_call_ms", float("inf")),
                                   time_ms(lambda: fn(*args)))
    return t


def time_pair(fm, args):
    """The kernel and its plain version in turns (plain first)."""
    return time_in_turns(("plain", fm.fused_match_plain), ("kernel", fm.fused_match), args)


def bound(fm, args):
    """Least time for this call on an H100 SXM: the larger of its bytes
    (inputs read once, outputs written once) over HBM bandwidth, and its
    operations over peak rates: a window test per (active row, keypoint)
    in f32, and a ±1 dot product per in-window pair as int8 tensor-core
    work (the cheapest exact form of a Hamming distance). Counts this
    call's data, not the worst case."""
    lm_desc, lm_meta, kp_desc, kp_meta = args
    L, N = lm_desc.shape[0], kp_desc.shape[0]
    active = lm_meta[:, 2] >= 0
    n_active = int(active.sum().item())
    rows = lm_meta[active]
    in_win = (
        ((rows[:, 0:1] - kp_meta[None, :, 0]).abs() <= rows[:, 2:3])
        & ((rows[:, 1:2] - kp_meta[None, :, 1]).abs() <= rows[:, 2:3])
        & ((rows[:, 3:4] - kp_meta[None, :, 2]).abs() <= fm.LEVEL_WINDOW)
    )
    pairs = int(in_win.sum().item())
    nbytes = sum(t.numel() * t.element_size() for t in args) + L * 12
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * DIST_OPS / INT8_TC_OPS_PER_S + n_active * N * WINDOW_TEST_OPS / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_active, pairs)


def measured_tiles(fm, args):
    """The kernel's own tile counts (walked, sent to the b1 mma) for one
    call on ``args``, from its counting build."""
    fm.count_tiles(True)
    fm.fused_match(*args)
    return fm.count_tiles(False)


def time_saved_inputs(sites):
    """Phase 5's timings, run by time_in_child: for each of ``sites``'
    saved input, time_pair's numbers and the yardstick, printed as one
    JSON line."""
    from structure_plp_slam_tpu_torch.ops import fused_match as fm

    inputs = torch.load(INPUTS)
    device_ms(lambda: torch.ones(1024, device="cuda").add_(1), reps=2, warmup=1)
    out = {}
    for site in sites:
        args = tuple(a.cuda() for a in inputs[site])
        out[site] = {**time_pair(fm, args), "yardstick_ms": bitplane_yardstick_ms(args)}
    print(json.dumps(out))


def time_in_child(sites):
    """time_saved_inputs in a fresh process. Once the main path has run,
    the profiler sessions of this process come back short of kernel
    records (18-19 of 20 on the H100, or none), while a fresh process's
    come back whole."""
    res = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.time_saved_inputs({list(sites)!r})"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900,
    )
    if res.returncode != 0:
        raise RuntimeError(f"phase 5 timing failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def bitplane_yardstick_ms(args):
    """A bf16 matmul of the ±1 bit planes: the distance part only, since no
    single PyTorch call computes the fused function."""
    shifts = torch.arange(32, device="cuda", dtype=torch.int32)

    def planes(d):
        return (((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256)
                .to(torch.bfloat16) * 2 - 1).contiguous()

    lm_bits, kp_bits = planes(args[0]), planes(args[2])
    return device_ms(lambda: torch.matmul(lm_bits, kp_bits.T))[0]


def profile_frames(make_system, frames, warm, count, feed=None, label="profile"):
    """torch.profiler over ``count`` frames after ``warm`` untraced ones:
    device kernels per frame, device busy share of the wall time, and the
    kernels with the most device time. ``feed(slam, frame)`` feeds one
    frame (RGB-D (image, depth, timestamp) by default)."""
    from torch.profiler import ProfilerActivity, profile

    if feed is None:
        def feed(slam, f):
            slam.feed_RGBD_frame(f[0], f[1], f[2])
    slam = make_system(verbose_timing=False)
    slam.startup()
    for f in frames[:warm]:
        feed(slam, f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[warm:warm + count]:
            feed(slam, f)
        slam.shutdown()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return trace_numbers(prof, wall_ms, count, label)


def profile_call(fn, label):
    """torch.profiler over one call of ``fn`` (trace_numbers per call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return trace_numbers(prof, wall_ms, 1, label, unit="call")


def trace_numbers(prof, wall_ms, count, label, unit="frame"):
    """A trace's device kernels per ``unit`` (``count`` of them in
    ``wall_ms``), the device busy share of the wall time, the kernels
    with the most device time and the per-stage numbers; None (and a
    line saying so) if the trace holds no device activity."""
    from torch.autograd import DeviceType

    # Kernels, copies and fills only: the device timeline also mirrors the
    # stage ranges, under the ranges' own names.
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith("stage.")]
    if not kernels:
        print(f"{label}: the profiler recorded no device activity (not measured)")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]

    # Per stage (the StageTimer's ``stage.<name>`` ranges): device ops and
    # device time of the kernels launched by the ops inside the range
    # (the fused matcher's ctypes launches have no op above them and are
    # not counted here), and the range's host time.
    def subtree(e):
        n, us = len(e.kernels), sum(k.duration for k in e.kernels)
        for c in e.cpu_children:
            cn, cus = subtree(c)
            n, us = n + cn, us + cus
        return n, us

    stages = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("stage."):
            n, us = subtree(e)
            s = stages.setdefault(e.name[len("stage."):], [0, 0, 0.0, 0.0])
            s[0] += 1
            s[1] += n
            s[2] += us
            s[3] += e.cpu_time_total
    out = {
        f"{unit}s": count,
        f"wall_ms_per_{unit}": wall_ms / count,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / count,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        f"device_ops_per_{unit}": len(kernels) / count,
        "top": [{"name": n[:80], "count": c, "ms": t / 1e3} for n, (c, t) in top],
        "stages": {k: {"calls": c, "device_ops_per_call": n / c, "device_ms_per_call": us / c / 1e3,
                       "host_ms_per_call": cpu / c / 1e3}
                   for k, (c, n, us, cpu) in stages.items()},
    }
    print(f"{label}: {count} {unit}s, wall {out[f'wall_ms_per_{unit}']:.3f} ms/{unit}, device "
          f"busy {out[f'device_busy_ms_per_{unit}']:.3f} ms/{unit}, idle share "
          f"{out['device_idle_share']:.4f}, {out[f'device_ops_per_{unit}']:.1f} device ops/{unit}")
    for name, s in out["stages"].items():
        print(f"{label} stage {name}: {s['calls']} calls, {s['device_ops_per_call']:.1f} device "
              f"ops, {s['device_ms_per_call']:.3f} device ms, {s['host_ms_per_call']:.3f} host ms "
              f"per call (under the profiler)")
    for t in out["top"]:
        print(f"{label} top: {t['ms']:.3f} ms in {t['count']} x {t['name']}")
    return out


class SiteRecorder:
    """Wraps the fused matcher where the tracker and the mapper call it.
    Per call site (stage 1 has the keypoint slot count of rows, stage 2
    any other count; the mapper's is fuse, or loop_fuse while the System's
    loop fix runs, whose method the recorder wraps to say so) it counts
    the calls, and the kernel launches as the wrapper's own launch counter
    moves across each call; it keeps every call's inputs for the exact
    check. The relocalizer's candidates go through
    ``tracker.track_frame``, so the tracker's name covers them."""

    def __init__(self, fm, tracker, mapper, num_kps):
        from structure_plp_slam_tpu_torch.system import System

        self.fm, self.tracker, self.mapper, self.num_kps = fm, tracker, mapper, num_kps
        self.system_cls = System
        self.in_loop_fix = False
        self.calls = {site: 0 for site in CALL_SITES}
        self.launches = {site: 0 for site in CALL_SITES}
        self.inputs = []

    def _wrap(self, site_of):
        def call(*args):
            site = site_of(args)
            self.calls[site] += 1
            self.inputs.append((site, tuple(a.clone() for a in args)))
            before = self.fm.fused_match.launches
            out = self.fm.fused_match(*args)
            self.launches[site] += self.fm.fused_match.launches - before
            return out
        return call

    def inputs_at(self, site):
        return [args for s, args in self.inputs if s == site]

    def __enter__(self):
        self.tracker.fused_match = self._wrap(
            lambda a: "track_stage1" if a[0].shape[0] == self.num_kps else "track_stage2")
        self.mapper.fused_match = self._wrap(
            lambda a: "loop_fuse" if self.in_loop_fix else "fuse")
        self.advance_fix = advance = self.system_cls._advance_pending_fix

        def advance_in_fix(slam):
            self.in_loop_fix = True
            try:
                return advance(slam)
            finally:
                self.in_loop_fix = False

        self.system_cls._advance_pending_fix = advance_in_fix
        return self

    def __exit__(self, *exc):
        self.tracker.fused_match = self.fm.fused_match
        self.mapper.fused_match = self.fm.fused_match
        self.system_cls._advance_pending_fix = self.advance_fix


class PlainRecorder:
    """Wraps the masked matchers of ops/matching.py (the distance matrix of
    the ±1 bit planes and the windowed matchers over it), the route the
    equirectangular model takes in place of the kernel. It counts each
    function's calls (the outermost only: ``match_by_projection`` computes
    its distance matrix inside) and keeps their inputs and outputs on the
    host for ``check``, int64 tensors as int32 (distances, levels and
    keypoint indices all fit)."""

    NAMES = ("distance_matrix_mxu", "match_by_projection_precomputed",
             "match_by_projection", "match_in_area")

    def __init__(self):
        from structure_plp_slam_tpu_torch.ops import matching

        self.matching = matching
        self.fns = {n: getattr(matching, n) for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}
        self.records = []
        self.depth = 0

    @staticmethod
    def _host(x):
        if not torch.is_tensor(x):
            return x
        return (x.to(torch.int32) if x.dtype == torch.int64 else x).cpu()

    @staticmethod
    def _back(x):
        return x.to(torch.int64) if torch.is_tensor(x) and x.dtype == torch.int32 else x

    def _wrap(self, name):
        fn = self.fns[name]

        def call(*args, **kw):
            self.depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self.depth -= 1
            if self.depth == 0:
                self.calls[name] += 1
                outs = out if isinstance(out, tuple) else (out,)
                self.records.append((name, [self._host(a) for a in args],
                                     {k: self._host(v) for k, v in kw.items()},
                                     [self._host(o) for o in outs]))
            return out
        return call

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.matching, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.fns.items():
            setattr(self.matching, n, fn)

    def check(self, name):
        """Every recorded call run again on the CPU by the same function:
        the outputs (indices, distances) must be equal. Returns the largest
        absolute difference (0.0) and the calls checked by function."""
        err, t0 = 0.0, time.perf_counter()
        for k, (fn_name, args, kw, outs) in enumerate(self.records):
            again = self.fns[fn_name](*[self._back(a) for a in args],
                                      **{key: self._back(v) for key, v in kw.items()})
            again = again if isinstance(again, tuple) else (again,)
            for a, b in zip(outs, again):
                a = self._back(a).to(torch.int64)
                if not torch.equal(a, b.to(torch.int64)):
                    raise AssertionError(f"path {name}: {fn_name} call {k} on the card differs "
                                         f"from the CPU on {int((a != b).sum())} entries")
                err = max(err, float((a - b).abs().max().item()) if a.numel() else 0.0)
        print(f"masked matcher card == CPU: path {name}, all {len(self.records)} calls "
              f"{self.calls} (max_abs_err {err}; checked in {time.perf_counter() - t0:.1f} s)")
        return err


def drive_path(name, fm, recorder, slam, feed, items, plain=None):
    """Drive one path with the kernel's counts set to 0 just before and
    read just after. ``feed(slam, item)`` feeds one frame and returns
    its pose or None. ``plain``: a PlainRecorder for a path that matches
    through the masked matchers by design (equirectangular): its kernel
    launches must be 0, and every matcher call it implies must have gone
    through those matchers, equal to their CPU run. Returns the run's
    numbers."""
    slam.startup()
    base = structure_counts(slam)
    torch.cuda.synchronize()
    fm.reset_counts()
    tracked = 0
    t0 = time.perf_counter()
    with recorder, (plain or contextlib.nullcontext()):
        for item in items:
            if feed(slam, item) is not None:
                tracked += 1
            torch.cuda.synchronize()
        slam.shutdown()  # the last frames' decisions (keyframes, relocalization)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return path_numbers(name, fm, recorder, slam, base, len(items), tracked, wall, plain)


def structure_counts(slam):
    """The System's counts that imply its matcher calls: track steps,
    relocalization attempts, keyframe chains, loops closed."""
    return (slam.num_track_steps, len(slam.timer.times.get("relocalize", [])),
            len(slam.timer.times.get("keyframe.chain", [])), slam.loop_closer.num_loops_closed)


def path_numbers(name, fm, recorder, slam, base, n_items, tracked, wall, plain=None):
    """A driven path's numbers and its kernel checks (see drive_path):
    ``base`` is structure_counts before the run, ``n_items`` the frames
    fed, ``tracked`` how many returned a pose, ``wall`` the run's seconds."""
    launches, calls = fm.fused_match.launches, fm.fused_match.calls
    by_rows = dict(fm.fused_match.launches_by_rows)
    timing = slam.timer.summary()
    # Matcher calls the structure of the run implies: three per
    # track_frame (one per tracked frame, three per relocalization
    # attempt: one per candidate), one per keyframe chain, one per loop
    # correction.
    steps, relocs, chains, loops = (b - a for a, b in zip(base, structure_counts(slam)))
    frames_tf = steps + 3 * relocs
    expected = {"track_stage1": 2 * frames_tf, "track_stage2": frames_tf, "fuse": chains,
                "loop_fuse": loops}
    run = {"path": name, "frames": n_items, "tracked": tracked, "wall_s": wall,
           "frames_per_s": n_items / wall, "launches": launches, "calls": calls,
           "site_calls": dict(recorder.calls), "site_launches": dict(recorder.launches),
           "expected_site_calls": expected, "launches_by_rows": by_rows,
           "relocalize_calls": relocs, "chains": chains, "loops_closed": loops,
           "state": slam.tracking_state.value, "keyframes": slam.num_keyframes,
           "landmarks": slam.num_landmarks, "relocalizations": slam.num_relocalizations,
           "max_keyframes": slam.max_keyframes, "max_landmarks": slam.max_landmarks,
           "stage_median_ms": {k: v["median_ms"] for k, v in timing.items()},
           "stage_count": {k: v["count"] for k, v in timing.items()}}
    print(f"path {name}: {n_items} frames, tracked {tracked}, state {run['state']}, "
          f"keyframes {run['keyframes']} (chains {chains}), landmarks {run['landmarks']}, "
          f"relocalizations {run['relocalizations']} of {relocs} attempts, capacities "
          f"K={slam.max_keyframes} L={slam.max_landmarks}")
    print(f"path {name} frames/s: {run['frames_per_s']:.3f} over all {n_items} frames "
          f"(stage-synced timer {'on' if slam.timer.synced else 'off'})")
    for stage, s in timing.items():
        print(f"path {name} stage {stage}: count {s['count']} median {s['median_ms']:.3f} ms "
              f"mean {s['mean_ms']:.3f} ms max {s['max_ms']:.3f} ms")
    print(f"path {name} card: {card_line()}")
    print(f"path {name}: fused_match launches {launches} of {calls} calls; by site "
          f"{run['site_launches']} launches of {run['site_calls']} calls, expected {expected}"
          f"{' through the masked matchers' if plain else ''}; by rows {by_rows}")
    if plain is not None:
        # Stage 1 and 2 of each track_frame are three windowed matches over
        # the precomputed distances; each fuse is one match_by_projection.
        want = {"match_by_projection_precomputed": 3 * frames_tf,
                "match_by_projection": chains + loops}
        got = {k: plain.calls[k] for k in want}
        print(f"path {name}: masked matcher calls {plain.calls}, expected {want}")
        if launches or calls or any(run["site_calls"].values()) or got != want:
            raise AssertionError(f"path {name}: the kernel was called ({calls}) or the masked "
                                 f"matchers were not called as expected ({got} != {want})")
        run["plain_calls"] = dict(plain.calls)
        run["max_abs_err"], run["max_abs_err_by_site"] = plain.check(name), {}
        return run
    if not (launches == calls == sum(expected.values())
            and run["site_launches"] == run["site_calls"] == expected):
        raise AssertionError(f"path {name}: not every matcher call launched the kernel")
    errs = {}
    for k, (site, args) in enumerate(recorder.inputs):
        errs[site] = max(errs.get(site, 0.0), check_exact(fm, args, f"{name} {site} call {k}"))
    print(f"kernel == plain: path {name}, all {len(recorder.inputs)} matcher calls "
          f"(max_abs_err by site {errs})")
    run["max_abs_err"] = max(errs.values(), default=0.0)
    run["max_abs_err_by_site"] = errs
    return run


def ate_of(traj_io, slam, poses, align_scale, fps=30.0):
    """ATE of the frame trajectory against poses fed at ``fps``."""
    gt = [(float(i) / fps, np.concatenate([R, t[:, None]], 1)) for i, (R, t) in enumerate(poses)]
    return traj_io.ate_rmse(slam.frame_trajectory(), gt, align_scale=align_scale)


def gate(name, cond, what):
    if not cond:
        raise AssertionError(f"path {name}: {what}")


def center_error(slam, pose):
    """Distance of the last trajectory entry's camera centre from
    ``pose``'s (the relocalized pose lands in the trajectory, not in the
    feed's return value, which is the tracker's)."""
    P = slam.frame_trajectory()[-1][1]
    R, t = pose
    return float(np.linalg.norm(-P[:, :3].T @ P[:, 3] + R.T @ t))


@contextlib.contextmanager
def deterministic():
    """Fixed summation orders inside: the Gauss-Newton solvers' segment
    sums (index_add_, index_put_ with accumulate) otherwise add in another
    order on every run on the card, and the monocular path follows them
    chaotically (its gated sequence read 0.068-0.084 m over runs of one
    code). The sums then sort their indices, about a third more device
    operations per frame, so only the monocular phase runs so."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def blackout_items(frames, shown, black_ts, turn=False):
    """``frames``, two black frames (depth 1 everywhere), ``frames[shown]``
    again: the relocalization scenario of tests/test_loop_system.py.
    ``turn``: the frame shown again is seen by the camera turned 180
    degrees about its optical axis (the principal point is the image
    centre, so that is the image and depth map turned round: R ->
    diag(-1, -1, 1) R, the same centre)."""
    black = np.zeros_like(frames[0][0])
    ones = np.ones_like(frames[0][1])
    img, depth, _ = frames[shown]
    if turn:
        img, depth = (np.ascontiguousarray(a[::-1, ::-1]) for a in (img, depth))
    return (list(frames) + [(black, ones, black_ts), (black, ones, black_ts + 1 / 30.0)]
            + [(img, depth, black_ts + 0.1)])


def sync_check():
    """Whether torch.linalg.svd / eigh / det on CUDA make the host wait, at
    the shapes the slice uses: each call runs behind ~20 ms of queued
    matmuls, and its host time (call to return) is compared with that;
    torch's sync debug mode counts the synchronizations it sees."""
    import warnings

    g = torch.Generator(device="cuda").manual_seed(0)
    big = torch.randn(4096, 4096, device="cuda", generator=g)
    cases = {
        "svd [256,8,9] (8-point E)": (torch.randn(256, 8, 9, device="cuda", generator=g),
                                      lambda a: torch.linalg.svd(a, full_matrices=True)),
        "svd [256,12,12] (PnP DLT)": (torch.randn(256, 12, 12, device="cuda", generator=g),
                                      lambda a: torch.linalg.svd(a)),
        "svd [3,3]": (torch.randn(3, 3, device="cuda", generator=g), torch.linalg.svd),
        "eigh [9,9] (coherent refit)": (torch.eye(9, device="cuda") * 2, torch.linalg.eigh),
        "eigh [1032,4,4] (triangulation)": (
            torch.eye(4, device="cuda").expand(1032, 4, 4).contiguous() * 3, torch.linalg.eigh),
        "det [256,3,3]": (torch.randn(256, 3, 3, device="cuda", generator=g), torch.linalg.det),
    }
    out = {}
    for name, (a, fn) in cases.items():
        fn(a)
        torch.cuda.synchronize()
        a_ev, b_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a_ev.record()
        for _ in range(8):
            big @ big
        b_ev.record()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        busy_ms = a_ev.elapsed_time(b_ev)
        syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
        waited = host_ms > 0.5 * busy_ms
        out[name] = {"host_ms": host_ms, "queued_device_ms": busy_ms,
                     "sync_warnings": syncs, "host_waited": waited}
        print(f"sync check: {name}: host {host_ms:.3f} ms behind {busy_ms:.3f} ms of queued "
              f"device work; sync-debug warnings {syncs}; "
              f"{'the host waited' if waited else 'no host wait'}")
    return out


def other_paths(fm, cam, cfg, N, device="cuda", capacities=(256, 32768)):
    """Phases 7-10: the monocular, stereo, relocalization and growth paths
    at the main path's width (640x480, 1000 keypoints over 8 levels) and
    capacities, each with its gates. Returns each path's numbers."""
    import dataclasses

    from structure_plp_slam_tpu_torch.camera import CameraSetup
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    runs = {}

    def system(config, **kw):
        kw = {"max_keyframes": capacities[0], "max_landmarks": capacities[1], **kw}
        return System(config, enable_loop_closing=False, verbose_timing=True,
                      device=device, **kw)

    def recorder():
        return SiteRecorder(fm, tracker, mapper, N)

    rgbd_feed = lambda s, f: s.feed_RGBD_frame(f[0], f[1], f[2])  # noqa: E731

    # ---- 7. monocular: 40 frames, 0.08 m a frame (test_mono_sequence_ate)
    # tests/test_system_e2e.py's monocular test (numpy seed 42) gated at its
    # own configuration (320x240, 600 keypoints over 4 levels, 16 frames, K
    # = 32, L = 8192: mono_320); at the main path's width the same sequence
    # (40 frames) is gated on its state and trajectory and on
    # MONO_FULL_WIDTH_ATE, the seed-0 and seed-1 sequences reported. At that
    # width the JAX System itself ends at Sim3 ATE 0.115389 m on the CPU,
    # over the test's 0.08 m (ROADMAP C45; tests/test_torch_mono.py's slow
    # full-width tests print both Systems' runs on the CPU).
    mono_cam = dataclasses.replace(cam, setup=CameraSetup.MONOCULAR, focal_x_baseline=0.0)
    small = dataclasses.replace(mono_cam, cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5,
                                cy=119.5)
    mono_feed = lambda s, f: s.feed_monocular_frame(f[0], f[2])  # noqa: E731
    for seed, name, c, orb, caps, n in (
            (42, "mono", mono_cam, cfg.orb, capacities, NUM_FRAMES),
            (42, "mono_320", small, OrbParams(max_num_keypts=600, num_levels=4), (32, 8192), 16),
            (0, "mono_seed0", mono_cam, cfg.orb, capacities, REPORTED_MONO_FRAMES),
            (1, "mono_seed1", mono_cam, cfg.orb, capacities, REPORTED_MONO_FRAMES)):
        frames, poses = synthetic_scene.make_sequence(np.random.default_rng(seed), c, n,
                                                      step=0.08)
        slam = system(dataclasses.replace(cfg, camera=c, orb=orb), max_kf_interval=3,
                      max_keyframes=caps[0], max_landmarks=caps[1])
        with deterministic():
            r = drive_path(name, fm, SiteRecorder(fm, tracker, mapper, slam.frontend.pad_to),
                           slam, mono_feed, frames)
        ate = ate_of(traj_io, slam, poses, align_scale=True)
        n_traj = len(slam.frame_trajectory())
        gated = name in ("mono", "mono_320")
        r["gates"] = {"seed": seed, "width": c.cols, "ate_sim3_m": ate,
                      "trajectory_frames": n_traj, "ate_gated": gated}
        print(f"path {name}: {c.cols}x{c.rows}, Sim3-aligned ATE {ate:.6f} m over {n_traj} "
              f"trajectory frames{'' if gated else ' (ATE reported, not gated)'}"
              + (f"; the JAX System on the CPU: {JAX_CPU_MONO_ATE:.6f} m (PERF.md)"
                 if name == "mono" else ""))
        runs[name] = r
    for name, n, need in (("mono", NUM_FRAMES, 30), ("mono_320", 16, 10)):
        r = runs[name]
        gate(name, r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
        gate(name, r["gates"]["trajectory_frames"] >= need,
             f"{r['gates']['trajectory_frames']} of {n} frames in the trajectory")
    for name, bound in (("mono", MONO_FULL_WIDTH_ATE), ("mono_320", 0.08)):
        ate = runs[name]["gates"]["ate_sim3_m"]
        gate(name, ate < bound, f"Sim3 ATE {ate} >= {bound} m")

    # ---- 8. stereo: 40 rendered pairs, 0.1 m baseline --------------------
    baseline = 0.1
    st_cam = dataclasses.replace(cam, setup=CameraSetup.STEREO,
                                 focal_x_baseline=cam.fx * baseline)
    rng = np.random.default_rng(0)
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(NUM_FRAMES)
    pairs = []
    for i, (R, t) in enumerate(poses):
        left, _ = synthetic_scene.render(st_cam, tex, R, t)
        right, _ = synthetic_scene.render(st_cam, tex, R, t - np.array([baseline, 0.0, 0.0]))
        pairs.append((left, right, float(i) / 30.0))
    slam = system(dataclasses.replace(cfg, camera=st_cam))
    r = drive_path("stereo", fm, recorder(), slam,
                   lambda s, f: s.feed_stereo_frame(f[0], f[1], f[2]), pairs)
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    r["gates"] = {"ate_m": ate}
    print(f"path stereo: ATE {ate:.6f} m")
    gate("stereo", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("stereo", r["tracked"] >= NUM_FRAMES - 1, f"tracked {r['tracked']} of {NUM_FRAMES}")
    gate("stereo", r["landmarks"] > 200, f"{r['landmarks']} landmarks")
    gate("stereo", ate < 0.06, f"ATE {ate} >= 0.06 m")
    runs["stereo"] = r

    # ---- 9. relocalization: two blackouts (two black frames, then a
    # frame shown again), on tests/test_loop_system.py's 8 frames with the
    # default keyframe interval: with its max_kf_interval=2, local BA at
    # this width pulls the second keyframe over half a metre off its
    # place, in the JAX System as in the port (ROADMAP C15), and the
    # poses recorded against it with it.
    # (a) frame 4 again. The tracker, not the relocalizer, takes it back
    #     (its descriptor fallback against the reference keyframe; the
    #     JAX System relocalizes 0 times there too).
    # (b) a kidnapped camera: frame 4 again, seen by the camera turned
    #     upside down. The tracker cannot turn its motion-model pose
    #     round; the relocalizer's retrieval and PnP are rotation-blind.
    def blackout(name, frames, poses, shown, black_ts, turn=False):
        slam = system(cfg)
        items = blackout_items(frames, shown, black_ts, turn)
        r = drive_path(name, fm, recorder(), slam, rgbd_feed, items[:-1])
        lost_state = r["state"]
        r2 = drive_path(f"{name}_reshow", fm, recorder(), slam, rgbd_feed, items[-1:])
        err = center_error(slam, poses[shown])
        r.update(frames=len(items), state=r2["state"], relocalizations=r2["relocalizations"],
                 gates={"state_after_black": lost_state, "shown": shown,
                        "center_error_m": err})
        for key in ("launches", "calls", "relocalize_calls", "max_abs_err"):
            r[key] = max(r[key], r2[key]) if key == "max_abs_err" else r[key] + r2[key]
        for key in ("site_calls", "site_launches"):
            r[key] = {k: r[key][k] + r2[key][k] for k in CALL_SITES}
        r["stage_median_ms"]["relocalize_reshow"] = r2["stage_median_ms"].get("relocalize")
        print(f"path {name}: {lost_state} after the black frames, {r['state']} after frame "
              f"{shown}, {r['relocalizations']} relocalizations, centre {err:.6f} m from its "
              f"ground truth")
        gate(name, lost_state == TrackerState.LOST.value, f"{lost_state} after black")
        gate(name, r["state"] == TrackerState.TRACKING.value, f"ended {r['state']}")
        gate(name, r["relocalize_calls"] >= 2, "the black frames ran no relocalizer")
        runs[name] = r
        return r

    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(0), cam, 8)
    r = blackout("reloc_blackout", frames, poses, 4, 0.4)
    gate("reloc_blackout", r["gates"]["center_error_m"] < 0.08,
         f"centre {r['gates']['center_error_m']} m from frame 4")

    r = blackout("reloc_kidnap", frames, poses, 4, 0.4, turn=True)
    gate("reloc_kidnap", r["relocalizations"] >= 1, "no relocalization")
    gate("reloc_kidnap", r["gates"]["center_error_m"] < 0.08,
         f"centre {r['gates']['center_error_m']} m from frame 4")

    # ---- 10. growth: the RGB-D sequence from K = 4, L = 2048 ------------
    # (the first frame's depth seeds leave less than the two frames of
    # keypoint slots of headroom that growth keeps: L doubles at once).
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(0), cam, NUM_FRAMES)
    slam = system(cfg, max_keyframes=4, max_landmarks=2048)
    r = drive_path("growth", fm, recorder(), slam, rgbd_feed, frames)
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    r["gates"] = {"ate_m": ate}
    print(f"path growth: ATE {ate:.6f} m, capacities grew to K={r['max_keyframes']} "
          f"L={r['max_landmarks']}")
    gate("growth", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("growth", r["max_keyframes"] > 4 and r["max_landmarks"] > 2048, "no growth")
    gate("growth", ate < 0.05, f"ATE {ate} >= 0.05 m")
    runs["growth"] = r
    return runs


# Phase 8 (b)'s dataset cameras as their YAML gives them (run.py's euroc
# and kitti subcommands read such files). EuRoC: the reference's
# example/euroc/EuRoC_stereo.yaml (tests/test_rectify.py), without its
# StereoRectifier node, since the rendered pairs are rectified already.
# KITTI: OpenVSLAM's example/kitti/KITTI_stereo_00-02.yaml.
DATASET_CAMERAS = {
    "stereo_euroc": """Camera.name: "EuRoC stereo"
Camera.setup: "stereo"
Camera.model: "perspective"
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.fps: 20.0
Camera.cols: 752
Camera.rows: 480
Camera.focal_x_baseline: 47.90639384423901
Feature.max_num_keypoints: 1000
Feature.num_levels: 8
Feature.scale_factor: 1.2
""",
    "stereo_kitti": """Camera.name: "KITTI stereo 00-02"
Camera.setup: "stereo"
Camera.model: "perspective"
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.fps: 10.0
Camera.cols: 1241
Camera.rows: 376
Camera.focal_x_baseline: 386.1448
depth_threshold: 40
Feature.max_num_keypoints: 2000
Feature.num_levels: 8
Feature.scale_factor: 1.2
""",
}
DATASET_FRAMES = 24
# The renderer's plane half-width at the dataset cameras: at KITTI's ~82
# degrees across (EuRoC's ~80) the default 5 m plane at z = 6 ends inside
# the view, and its clamped edge texels give the stereo matcher nothing.
DATASET_PLANE_HALF = 8.0


def dataset_config(name):
    """Phase 8 (b)'s Config for ``name`` of DATASET_CAMERAS, through the
    port's YAML loader."""
    from structure_plp_slam_tpu_torch.config import load_config

    return load_config(yaml_text=DATASET_CAMERAS[name])


def dataset_pairs(cam, n=DATASET_FRAMES):
    """Phase 8's scene at ``cam``: its texture (numpy seed 0) and
    trajectory, the right view at ``t - [b, 0, 0]`` (b = focal_x_baseline
    / fx), ``n`` pairs stamped at the camera's fps; and the poses."""
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    b = cam.focal_x_baseline / cam.fx
    tex = synthetic_scene.make_texture(np.random.default_rng(0))
    poses = synthetic_scene.trajectory(n)
    pairs = []
    for i, (R, t) in enumerate(poses):
        left, _ = synthetic_scene.render(cam, tex, R, t, plane_half=DATASET_PLANE_HALF)
        right, _ = synthetic_scene.render(cam, tex, R, t - np.array([b, 0.0, 0.0]),
                                          plane_half=DATASET_PLANE_HALF)
        pairs.append((left, right, float(i) / cam.fps))
    return pairs, poses


def dataset_stereo_paths(fm, capacities=(256, 32768), device="cuda"):
    """Phase 8 (b): ``System.feed_stereo_frame`` at the EuRoC and KITTI
    cameras (DATASET_CAMERAS: 752x480 with 1000 keypoints, 1241x376 with
    2000, 8 levels at 1.2; the keypoint slots 1,032 and 2,040), 24 pairs
    of phase 8's scene each, at K = 256 and L = 32768, driven as phase 8
    is: TRACKING, tracked >= 23, > 200 landmarks, ATE < 0.06 m, every
    matcher call on the kernel and equal to its plain twin. Returns each
    path's numbers (peak device memory in its gates) and the KITTI path's
    last stage-1 and stage-2 matcher inputs, for timing."""
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.system import System, TrackerState

    runs, inputs = {}, {}
    for name in DATASET_CAMERAS:
        cfg = dataset_config(name)
        cam = cfg.camera
        pairs, poses = dataset_pairs(cam)
        slam = System(cfg, max_keyframes=capacities[0], max_landmarks=capacities[1],
                      enable_loop_closing=False, verbose_timing=True, device=device)
        rec = SiteRecorder(fm, tracker, mapper, slam.frontend.pad_to)
        gc.collect()  # the earlier paths' Systems out of the peak
        torch.cuda.reset_peak_memory_stats()
        r = drive_path(name, fm, rec, slam, lambda s, f: s.feed_stereo_frame(f[0], f[1], f[2]),
                       pairs)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        ate = ate_of(traj_io, slam, poses, align_scale=False, fps=cam.fps)
        r["gates"] = {"ate_m": ate, "peak_mib": peak_mib, "camera": f"{cam.cols}x{cam.rows}",
                      "keypoint_slots": slam.frontend.pad_to,
                      "baseline_m": cam.focal_x_baseline / cam.fx}
        print(f"path {name}: {cam.cols}x{cam.rows}, {slam.frontend.pad_to} keypoint slots, "
              f"baseline {cam.focal_x_baseline / cam.fx:.4f} m, ATE {ate:.6f} m; peak "
              f"torch.cuda.max_memory_allocated {peak_mib:.1f} MiB")
        n = len(pairs)
        gate(name, r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
        gate(name, r["tracked"] >= n - 1, f"tracked {r['tracked']} of {n}")
        gate(name, r["landmarks"] > 200, f"{r['landmarks']} landmarks")
        gate(name, ate < 0.06, f"ATE {ate} >= 0.06 m")
        runs[name] = r
        if name == "stereo_kitti":
            inputs = {f"{name} {site}": rec.inputs_at(site)[-1]
                      for site in ("track_stage1", "track_stage2")}
    return runs, inputs


def inject_drift(slam):
    """tests/test_loop_system.py's drift: the later half of the map (the
    keyframes from next_kf // 2, the landmarks they made, the tracker
    pose) moved by a rigid transform larger than the tracker's
    association windows, so the revisit cannot re-attach on its own. The
    observations across the cut (a later keyframe's of an earlier
    landmark, and the reverse) are dropped, which keeps each half
    self-consistent: the JAX test moves the landmarks by their reference
    keyframe alone, and at this width the revisit's keyframes then hold
    landmarks ~1.1 m off in their own frames, so the Sim3 validation
    passes or fails by chance (ROADMAP C22)."""
    from structure_plp_slam_tpu_torch.ops import lie

    dev = slam.device
    T_R = lie.so3_exp(torch.tensor([0.0, 0.05, 0.0], device=dev))
    T_t = torch.tensor([0.9, 0.0, 0.3], device=dev)
    T_R_inv, T_t_inv = T_R.T, -T_R.T @ T_t
    st = slam.state
    kf_cut = slam.next_kf // 2
    K = st.kf_pose.shape[0]
    sel = (torch.arange(K, device=dev) >= kf_cut) & st.kf_valid
    R, t = st.kf_pose[:, :, :3], st.kf_pose[:, :, 3]
    pose = torch.where(sel[:, None, None], lie.pack_pose(R @ T_R_inv, R @ T_t_inv + t),
                       st.kf_pose)
    lm_late = st.lm_ref_kf >= kf_cut
    lm = torch.where((lm_late & st.lm_valid)[:, None], st.lm_pos @ T_R.T + T_t, st.lm_pos)
    idx = st.kf_lm_idx
    cross = (idx >= 0) & ((torch.arange(K, device=dev) >= kf_cut)[:, None]
                          != lm_late[torch.clamp(idx, min=0)])
    slam.state = st._replace(kf_pose=pose, lm_pos=lm, kf_lm_idx=torch.where(cross, -1, idx))
    Rp, tp = slam.pose
    slam.pose = (Rp @ T_R_inv, Rp @ T_t_inv + tp)


def loop_path(fm, cam, cfg, N, capacities=(256, 32768), mesh=None, name="loop", device="cuda"):
    """Phase 11: loop closing at the main path's width and capacities on
    tests/test_loop_system.py's organic out-and-back (numpy seed 0; the
    sequence of tests/test_torch_loop_system.py::
    test_full_width_loop_closure_matches_jax, where the JAX System closes
    the loop with max_kf_interval=2 at this width). The outbound leg and
    the return leg are driven in turn, the drift injected between them.
    ``mesh``: the System's ``loop_closer.mesh`` (phase 18; None, phase
    11's, solves on one device whatever cards are visible). Returns the
    run's numbers, the last loop_fuse call's inputs and the System."""
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    tex = synthetic_scene.make_texture(np.random.default_rng(0), size=1536)
    centres = ([np.array([0.4 * i, 0.0, 0.0]) for i in range(24)]
               + [np.array([0.4 * (23 - i), 0.0, 0.0]) for i in range(24)])
    frames = []
    for i, C in enumerate(centres):
        img, depth = synthetic_scene.render(cam, tex, np.eye(3), -C, plane_half=14.0)
        frames.append((img, depth, i / 30.0))
    slam = System(cfg, max_keyframes=capacities[0], max_landmarks=capacities[1],
                  max_kf_interval=2, verbose_timing=True, device=device)
    slam.loop_closer.mesh = mesh
    feed = lambda s, f: s.feed_RGBD_frame(f[0], f[1], f[2])  # noqa: E731
    validations = []  # [kf_cur, cand, matches, RANSAC inliers, refined inliers, scale]
    consume = slam.loop_closer.validate_consume

    def record_validation(packed):
        f = slam._pending_fix
        validations.append([f["kf_cur"], f["cand"], *packed.numpy()[:4].tolist()])
        return consume(packed)

    slam.loop_closer.validate_consume = record_validation
    r = drive_path(f"{name}_out", fm, SiteRecorder(fm, tracker, mapper, N), slam, feed,
                   frames[:24])
    gate(name, r["state"] == TrackerState.TRACKING.value, f"outbound leg ended {r['state']}")
    inject_drift(slam)
    # tests/test_loop_latency.py's instrument: which fed frame of the
    # return leg ran which loop-fix phase, and each feed's time.
    phase_frames, feed_s = [], []

    def spy():
        if slam._pending_fix is not None:
            phase_frames.append((len(feed_s), slam._pending_fix["phase"]))
        type(slam)._advance_pending_fix(slam)  # the class's, as SiteRecorder wraps it

    def timed_feed(s, f):
        t0 = time.perf_counter()
        out = feed(s, f)
        torch.cuda.synchronize()
        feed_s.append(time.perf_counter() - t0)
        return out

    slam._advance_pending_fix = spy
    back = SiteRecorder(fm, tracker, mapper, N)
    r2 = drive_path(f"{name}_back", fm, back, slam, timed_feed, frames[24:])
    del slam._advance_pending_fix
    med_s = float(np.median(feed_s))
    worst_over_median = float(np.max(feed_s)) / med_s
    st = slam.state
    kf_ts = st.kf_timestamp.cpu().numpy()
    last = int(np.argmax(kf_ts * st.kf_valid.cpu().numpy()))
    P = st.kf_pose[last].cpu().numpy()
    err = float(np.linalg.norm(-P[:, :3].T @ P[:, 3] - centres[int(round(kf_ts[last] * 30))]))
    fuse_inputs = back.inputs_at("loop_fuse")
    active = [int((a[1][:, 2] >= 0).sum().item()) for a in fuse_inputs]
    timing = slam.timer.summary()
    stages = ("loop_detect", "loopfix.validate", "loopfix.correct", "gba.prepare", "gba.chunk",
              "gba.adopt")
    run = dict(r2)
    for key in ("frames", "tracked", "launches", "calls", "relocalize_calls", "chains",
                "loops_closed"):
        run[key] = r[key] + r2[key]
    for key in ("site_calls", "site_launches"):
        run[key] = {k: r[key][k] + r2[key][k] for k in CALL_SITES}
    run["max_abs_err"] = max(r["max_abs_err"], r2["max_abs_err"])
    run["wall_s"] = r["wall_s"] + r2["wall_s"]
    run["frames_per_s"] = run["frames"] / run["wall_s"]
    run["gates"] = {
        "loops_closed": slam.loop_closer.num_loops_closed,
        "loop_edges": [list(e[:2]) for e in slam.loop_closer.loop_edges],
        "last_keyframe": last, "last_keyframe_error_m": err,
        "gba_adopt_count": timing.get("gba.adopt", {}).get("count", 0),
        "validations": validations,
        "loop_fuse_active_rows": active,
        "loop_stage_median_ms": {k: timing[k]["median_ms"] for k in stages if k in timing},
        "loop_stage_count": {k: timing[k]["count"] for k in stages if k in timing},
        "loopfix_phase_frames": phase_frames,
        "feed_median_s": med_s,
        "feed_max_over_median": worst_over_median,
    }
    print(f"path {name}: {run['frames']} frames at {run['frames_per_s']:.3f} frames/s; "
          f"{slam.loop_closer.num_loops_closed} loops closed {run['gates']['loop_edges']}; "
          f"last keyframe {last} centre {err:.6f} m from its ground truth; global BA merged "
          f"{run['gates']['gba_adopt_count']} times; loop_fuse active rows {active}; state "
          f"{run['state']}; validations [kf_cur, cand, matches, RANSAC inliers, refined "
          f"inliers, scale] {validations}")
    for k in stages:
        if k in timing:
            print(f"path {name} stage {k}: count {timing[k]['count']} median "
                  f"{timing[k]['median_ms']:.3f} ms max {timing[k]['max_ms']:.3f} ms")
    print(f"path {name}: loop-fix phases by fed frame of the return leg {phase_frames}; "
          f"largest feed {worst_over_median:.2f}x the median {med_s:.3f} s "
          f"(tests/test_loop_latency.py's bound 25x, reported); {card_line()}")
    phases_run = {p for _, p in phase_frames}
    gate(name, {"validate", "correct"} <= phases_run
         and len({i for i, _ in phase_frames}) >= 2,
         f"the loop fix's validate and correct did not run on different fed frames: "
         f"{phase_frames}")
    gate(name, slam.loop_closer.num_loops_closed >= 1, "no loop closed")
    gate(name, err < 0.35, f"last keyframe {err} m from its ground truth")
    gate(name, run["gates"]["gba_adopt_count"] >= 1, "the deferred global BA never merged")
    gate(name, run["state"] == TrackerState.TRACKING.value, f"ended {run['state']}")
    gate(name, fuse_inputs and min(active) > 0, f"loop_fuse active rows {active}")
    return run, fuse_inputs[-1], slam


MESH_SHARDS = 4  # phase 18: landmark shards on cuda:0
MESH_BOUNDS = (5e-3, 2e-2)  # tests/test_distributed_ba.py's: poses, landmarks
F64_BOUND = 1e-8  # phase 18 (c) in float64 (the CPU's gap: ~6e-12, sum_order.py)


@contextlib.contextmanager
def mesh_solve_recorder():
    """Wraps ``global_ba._run_global_ba_sharded``, the mesh solve the
    System's deferred global BA calls: per call, the host
    synchronizations torch's sync debug mode reports inside it (by
    file:line)."""
    import warnings

    from structure_plp_slam_tpu_torch.models import global_ba

    solve, solves = global_ba._run_global_ba_sharded, []

    def counted(*args, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = solve(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        at = {}
        for w in caught:
            if "synchroniz" in str(w.message).lower():
                k = f"{Path(str(w.filename)).name}:{w.lineno}"
                at[k] = at.get(k, 0) + 1
        solves.append({"total": sum(at.values()), "at": at})
        return out

    global_ba._run_global_ba_sharded = counted
    try:
        yield solves
    finally:
        global_ba._run_global_ba_sharded = solve


def mesh_against_single(name, cam, state, table, anchor, mesh, num_iters=10, cpu_mesh=None):
    """``run_global_ba`` on ``mesh`` against the single-device solve on the
    same state and anchor: the largest differences over the valid
    keyframes and landmarks, how far each solve moved the poses, each
    solve's median time over 3 calls between CUDA events (time_ms; the
    host's preparation inside) and one call of each under torch.profiler
    (device ops, busy share, the heaviest kernels). ``cpu_mesh``: also the
    same mesh solve on those CPU shards, on a CPU copy of the state, and
    the largest differences from it."""
    from structure_plp_slam_tpu_torch.models import global_ba

    def single():
        return global_ba.run_global_ba(cam, state, table, anchor_kf=anchor, num_iters=num_iters)

    def sharded():
        return global_ba.run_global_ba(cam, state, table, anchor_kf=anchor, num_iters=num_iters,
                                       mesh=mesh)

    ref, out = single(), sharded()  # also the first calls, outside the timing
    t1, tm = time_ms(single, reps=3, warmup=0), time_ms(sharded, reps=3, warmup=0)
    kv, lv = state.kf_valid, state.lm_valid

    def diffs(a, b):
        return (float((a.kf_pose - b.kf_pose.to(a.kf_pose.device))[kv].abs().max().item()),
                float((a.lm_pos - b.lm_pos.to(a.lm_pos.device))[lv].abs().max().item()))

    d_pose, d_lm = diffs(out, ref)
    moved = float((ref.kf_pose - state.kf_pose)[kv].abs().max().item())
    moved_mesh = float((out.kf_pose - state.kf_pose)[kv].abs().max().item())
    res = {"K": int(state.kf_pose.shape[0]), "keyframes": int(kv.sum().item()),
           "landmarks": int(lv.sum().item()), "anchor": int(anchor), "num_iters": num_iters,
           "shards": mesh.n_shards, "max_pose_diff": d_pose, "max_landmark_diff": d_lm,
           "single_moved_poses_by": moved, "mesh_moved_poses_by": moved_mesh, "mesh_ms": tm,
           "single_ms": t1, "route": "pcg" if state.kf_pose.shape[0] > 512 else "dense"}
    print(f"mesh solve {name}: {res['route']} K={res['K']} ({res['keyframes']} keyframes, "
          f"{res['landmarks']} landmarks), {mesh.n_shards} shards against one device: poses "
          f"{d_pose:.3e}, landmarks {d_lm:.3e} (the solves moved the poses by {moved:.3e} "
          f"single, {moved_mesh:.3e} mesh); mesh {tm:.3f} ms, single {t1:.3f} ms (medians of "
          f"3, CUDA events); {card_line()}")
    if cpu_mesh is not None:
        host = type(state)(*(t.cpu() for t in state))
        on_cpu = global_ba.run_global_ba(cam, host, table.cpu(), anchor_kf=anchor,
                                         num_iters=num_iters, mesh=cpu_mesh)
        res["max_pose_diff_cpu_mesh"], res["max_landmark_diff_cpu_mesh"] = diffs(out, on_cpu)
        print(f"mesh solve {name}: against the same solve on {cpu_mesh.n_shards} CPU shards: "
              f"poses {res['max_pose_diff_cpu_mesh']:.3e}, landmarks "
              f"{res['max_landmark_diff_cpu_mesh']:.3e}")
    res["profile_mesh"] = profile_call(sharded, f"profile {name} mesh")
    res["profile_single"] = profile_call(single, f"profile {name} single")
    return res


def pcg_gap_f64(cam, state, table, mesh):
    """Phase 18 (c)'s two PCG solves again with the map's poses and
    landmarks in float64: the float32 gap between the mesh and one device
    is summation order (ROADMAP C44) only if they agree to rounding here."""
    from structure_plp_slam_tpu_torch.models import global_ba

    st = state._replace(kf_pose=state.kf_pose.double(), lm_pos=state.lm_pos.double())
    one, out = (global_ba.run_global_ba(cam, st, table, anchor_kf=0, num_iters=2, mesh=m)
                for m in (None, mesh))
    res = {"max_pose_diff_f64": float((out.kf_pose - one.kf_pose)[st.kf_valid].abs().max()),
           "max_landmark_diff_f64": float((out.lm_pos - one.lm_pos)[st.lm_valid].abs().max()),
           "dtype_f64": str(out.kf_pose.dtype)}
    print(f"mesh solve mesh (c) in float64: {mesh.n_shards} shards against one device: poses "
          f"{res['max_pose_diff_f64']:.3e}, landmarks {res['max_landmark_diff_f64']:.3e} "
          f"({res['dtype_f64']}; bound {F64_BOUND:g})")
    return res


def mesh_paths(fm, cam, cfg, N, device="cuda"):
    """Phase 18: the landmark-sharded global BA. (a) phase 11's loop path
    with ``loop_closer.mesh`` = 4 shards on cuda:0 (and, with several
    cards, a mesh over all of them): phase 11's gates, every matcher call
    on the kernel and equal to its plain twin, and each deferred global
    BA merged through the mesh branch (one ``gba.chunk``, one mesh solve);
    host syncs per mesh solve. (b) the dense mesh solve on the map (a)
    leaves against the single-device solve, same anchor. (c) the PCG mesh
    route on testing/large_map.py's K = 1024 chain map, its poses
    perturbed, against the single-device PCG (ROADMAP C42), the same mesh
    solve on CPU shards, and the single-device PCG in float64 (C44).
    ``device="cpu"`` rehearses the phase on the CPU (with torch.cuda's
    synchronize, events and sync debug mode stubbed by the caller)."""
    from structure_plp_slam_tpu_torch.parallel.distributed_ba import LandmarkMesh
    from structure_plp_slam_tpu_torch.testing.large_map import build_large_map

    meshes = {"mesh": LandmarkMesh([f"{device}:0" if device == "cuda" else device]
                                   * MESH_SHARDS)}
    if device == "cuda" and torch.cuda.device_count() > 1:
        meshes["mesh_cards"] = LandmarkMesh(
            [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    runs = {}
    for name, mesh in meshes.items():
        torch.cuda.reset_peak_memory_stats()
        with mesh_solve_recorder() as solves:
            run, _, slam = loop_path(fm, cam, cfg, N, mesh=mesh, name=name, device=device)
        peak = torch.cuda.max_memory_allocated() / 2**20
        count = run["gates"]["loop_stage_count"]
        syncs = [s["total"] for s in solves]
        run["gates"].update({"shards": mesh.n_shards, "devices": [str(d) for d in mesh.devices],
                             "mesh_solves": len(solves), "syncs_per_mesh_solve": syncs,
                             "sync_sites": [s["at"] for s in solves], "peak_mib": peak})
        print(f"path {name}: {mesh.n_shards} landmark shards on {sorted(set(map(str, mesh.devices)))}; "
              f"{len(solves)} mesh solves, gba.chunk {count.get('gba.chunk', 0)}, gba.adopt "
              f"{count.get('gba.adopt', 0)}; host syncs per mesh solve {syncs} (by line "
              f"{[s['at'] for s in solves]}); peak torch.cuda.max_memory_allocated {peak:.1f} MiB")
        gate(name, len(solves) >= 1 and count.get("gba.chunk") == len(solves)
             >= count.get("gba.adopt", 0) >= 1,
             f"the deferred global BA did not merge through the mesh: {len(solves)} mesh solves, "
             f"stage counts {count}")
        r = mesh_against_single(f"{name} (b)", cam, slam.state, slam.frontend.inv_sigma_sq,
                                slam.loop_closer.loop_edges[-1][1], mesh)
        gate(name, r["max_pose_diff"] < MESH_BOUNDS[0] and r["max_landmark_diff"] < MESH_BOUNDS[1],
             f"dense mesh solve off the single-device one: {r}")
        run["mesh_solves"] = {"dense": r}
        runs[name] = run

    # (c) the PCG route past K = 512, on the K = 1024 chain map with 2 cm of
    # noise on every pose but the anchor's (as built, the map is at its
    # optimum and no solve moves it): held against the single-device PCG
    # (the chain preconditioner's blocks at the chain positions, ROADMAP
    # C42) and against the same mesh solve on CPU shards.
    mesh = meshes["mesh"]
    lcam, state, _ = build_large_map(np.random.default_rng(0), device=device)
    g = torch.Generator(device=device).manual_seed(0)
    pose = state.kf_pose.clone()
    pose[1:, :, 3] += torch.randn(pose.shape[0] - 1, 3, device=device, generator=g) * 0.02
    table = torch.ones(8, device=device)
    r = mesh_against_single("mesh (c)", lcam, state._replace(kf_pose=pose), table, 0, mesh,
                            num_iters=2, cpu_mesh=LandmarkMesh(["cpu"] * MESH_SHARDS))
    r.update(pcg_gap_f64(lcam, state._replace(kf_pose=pose), table, mesh))
    gate("mesh", r["max_pose_diff_f64"] < F64_BOUND and r["max_landmark_diff_f64"] < F64_BOUND,
         f"PCG mesh solve off the single-device PCG in float64: {r}")
    gate("mesh", r["mesh_moved_poses_by"] > 0.01,
         f"the PCG mesh solve moved the perturbed poses by {r['mesh_moved_poses_by']} m")
    gate("mesh", r["max_pose_diff"] < MESH_BOUNDS[0] and r["max_landmark_diff"] < MESH_BOUNDS[1],
         f"PCG mesh solve off the single-device PCG on the card: {r}")
    gate("mesh", r["max_pose_diff_cpu_mesh"] < MESH_BOUNDS[0]
         and r["max_landmark_diff_cpu_mesh"] < MESH_BOUNDS[1],
         f"PCG mesh solve on the card off the same solve on the CPU: {r}")
    runs["mesh"]["mesh_solves"]["pcg"] = r
    return runs


def ulps(a, b):
    """Largest distance in float32 units in the last place between two f32
    tensors of one sign pattern (0 where equal)."""
    if not a.numel():
        return 0
    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def card_vs_cpu(res, device, name, fn, *args, exact=True, atol=None, **kw):
    """``fn`` on the CPU and on ``device`` with the same inputs; every
    output compared (exact, within ``atol``, or within 1e-5 relative to
    max(|x|, 1)); the largest difference goes to ``res[name]``."""
    host = [a.cpu() if torch.is_tensor(a) else a for a in args]
    card = [a.to(device) if torch.is_tensor(a) else a for a in args]
    outs = fn(*host, **kw), fn(*card, **kw)
    outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
    err = 0.0
    for c, d in zip(*outs, strict=True):
        d = d.cpu()
        if c.shape != d.shape or c.dtype != d.dtype:
            raise AssertionError(f"public op {name}: {c.shape} {c.dtype} on the CPU, "
                                 f"{d.shape} {d.dtype} on the card")
        if exact:
            if not torch.equal(c, d):
                raise AssertionError(f"public op {name}: {int((c != d).sum())} entries "
                                     f"differ between the card and the CPU")
            continue
        diff = (d - c).abs()
        scale = torch.ones_like(c) if atol is not None else c.abs().clamp(min=1.0)
        limit = atol if atol is not None else 1e-5
        worst = float((diff / scale).max().item()) if c.numel() else 0.0
        if not worst <= limit:
            raise AssertionError(f"public op {name}: card off the CPU by {worst:.3e} "
                                 f"(bound {limit:.0e})")
        err = max(err, float(diff.max().item()) if c.numel() else 0.0)
    res[name] = err
    print(f"public op {name}: card == CPU ({'exact' if exact else f'max abs diff {err:.3e}'})")


def frontend_card_vs_cpu(res, both, img, n_kps, rng, label, device="cuda"):
    """The frontend's arithmetic on the f32 frame ``img``, card against
    CPU (ROADMAP C8): the 8-level pyramid and atlas bit-equal (``both``:
    card_vs_cpu into ``res``); ic_angles at 1000 random points within 2
    ulp (the one place the devices compute differently: glibc's atan2f /
    cosf / sinf on the CPU, torch's CUDA functions on the card); the
    extractor with ``n_kps`` keypoints over 8 levels: slots equal, angles
    within 2 ulp, the share of equal descriptors printed (a sample that
    an ulp of angle moves across a pixel's rounding edge flips a bit).
    Returns the random points and the CPU's angles there."""
    from structure_plp_slam_tpu_torch.ops import image, orb

    H, W = img.shape
    both("build_pyramid 8 levels x1.2", lambda im: image.build_pyramid(im, 8, 1.2), img)
    shapes = image.pyramid_shapes(H, W, 8, 1.2)
    offs, Ha, Wa = image.atlas_layout(shapes)
    both("build_atlas 8 levels x1.2", lambda im: image.build_atlas(im, shapes, offs, Ha, Wa), img)

    xy = torch.from_numpy(np.stack([rng.uniform(orb.EDGE_MARGIN, W - orb.EDGE_MARGIN, 1000),
                                    rng.uniform(orb.EDGE_MARGIN, H - orb.EDGE_MARGIN, 1000)],
                                   1).astype(np.float32))
    host_ang = orb.ic_angles(img, xy)
    card_ang = orb.ic_angles(img.to(device), xy.to(device)).cpu()
    res["ic_angles_max_ulp"] = ulps(host_ang, card_ang)
    res["ic_angles_equal_share"] = float((host_ang == card_ang).double().mean())
    print(f"public op ic_angles ({label}): card within {res['ic_angles_max_ulp']} ulp of the "
          f"CPU (equal on {res['ic_angles_equal_share']:.4f})")
    gate("public_ops", res["ic_angles_max_ulp"] <= 2,
         f"ic_angles {res['ic_angles_max_ulp']} ulp off the CPU ({label})")

    ex = orb.OrbExtractor(H, W, orb.OrbParams(max_num_keypts=n_kps, num_levels=8))
    fh, fc = ex(img), {k: v.cpu() for k, v in ex(img.to(device)).items()}
    for k in ("xy", "level", "valid", "response"):
        if not torch.equal(fh[k], fc[k]):
            raise AssertionError(f"OrbExtractor {k}: the card differs from the CPU ({label})")
    v = fh["valid"]
    res["extractor_keypoints"] = int(v.sum())
    res["extractor_angle_max_ulp"] = ulps(fh["angle"][v], fc["angle"][v])
    res["extractor_angles_equal_share"] = float((fh["angle"] == fc["angle"])[v].double().mean())
    res["extractor_desc_equal_share"] = float((fh["desc"] == fc["desc"]).all(1)[v].double().mean())
    print(f"OrbExtractor on {label} ({W}x{H}, {int(v.sum())} keypoints): slots equal; "
          f"angles within {res['extractor_angle_max_ulp']} ulp (equal on "
          f"{res['extractor_angles_equal_share']:.4f}); descriptors equal on "
          f"{res['extractor_desc_equal_share']:.4f}")
    gate("public_ops", res["extractor_angle_max_ulp"] <= 2,
         f"extractor angles {res['extractor_angle_max_ulp']} ulp off the CPU ({label})")
    return xy, host_ang


def dataset_frontends(device="cuda"):
    """Phase 19 (c): frontend_card_vs_cpu at phase 8 (b)'s two cameras,
    on each one's first left frame. Returns each camera's numbers."""
    out = {}
    for name in DATASET_CAMERAS:
        cfg = dataset_config(name)
        pairs, _ = dataset_pairs(cfg.camera, 1)
        img = torch.from_numpy(np.ascontiguousarray(pairs[0][0], dtype=np.float32))
        res = out[name] = {}
        frontend_card_vs_cpu(res, functools.partial(card_vs_cpu, res, device), img,
                             cfg.orb.max_num_keypts, np.random.default_rng(19),
                             f"{name}'s first left frame", device)
    return out


def public_ops(cam, frame, device="cuda"):
    """Phase 19: the port's public functions that no path calls, each on
    ``device`` against the same call on the CPU, at the main path's
    shapes (``frame``: a 640x480 image of its sequence; 1000 keypoints;
    8192 points, stage 2's rows). Masks, indices and descriptors must be
    equal; floats within 1e-5 relative to max(|x|, 1). The frontend's
    pyramid, atlas, moment maps and blurs bit-equal (ROADMAP C8);
    ic_angles within 1e-5 rad on the same moment maps and within 2 ulp
    from the image; the extractor's slots equal and angles within 2 ulp.
    Returns each check's largest difference and the shares."""
    from structure_plp_slam_tpu_torch.camera import perspective
    from structure_plp_slam_tpu_torch.ops import hamming, image, orb, triangulation

    rng = np.random.default_rng(19)
    res = {}
    both = functools.partial(card_vs_cpu, res, device)

    H, W = cam.rows, cam.cols
    img = torch.from_numpy(np.ascontiguousarray(frame, dtype=np.float32))
    pts = torch.from_numpy(np.stack([rng.uniform(-3, 3, 8192), rng.uniform(-2, 2, 8192),
                                     rng.uniform(0.3, 12, 8192)], 1).astype(np.float32))
    both("reproject_stereo", lambda p: perspective.reproject_stereo(cam, p), pts, exact=False)

    a = torch.from_numpy(rng.integers(-2**31, 2**31, (1024, 8), dtype=np.int64).astype(np.int32))
    flip = torch.from_numpy(rng.integers(-2**31, 2**31, (1000, 8), dtype=np.int64)
                            .astype(np.int32)) & 0x01010101
    b = a[torch.from_numpy(rng.permutation(1024)[:1000])] ^ flip
    b[900:950] = b[850:900]  # ties: the lower index wins
    dist = hamming.distance_matrix(a, b, torch.from_numpy(rng.uniform(size=1024) < 0.9),
                                   torch.from_numpy(rng.uniform(size=1000) < 0.9))
    for max_dist, ratio in ((50, None), (50, 0.8), (1024, None)):
        both(f"mutual_best_matches max_dist={max_dist} ratio={ratio}",
             lambda d: hamming.mutual_best_matches(d, max_dist, ratio), dist)

    # The frontend's own arithmetic: the same function on both devices
    # (ROADMAP C8). Pyramid, atlas, moment maps and blurs bit-equal.
    xy, host_ang = frontend_card_vs_cpu(res, both, img, 1000, rng, "the main path's frame",
                                        device)
    shapes = image.pyramid_shapes(H, W, 8, 1.2)
    atlas = image.build_atlas(img, shapes, *image.atlas_layout(shapes))
    both("ic_moment_maps", orb.ic_moment_maps, img)
    both("ic_moment_maps (the extractor's fused order, atlas)",
         lambda a: orb._moment_maps(a, fused=True), atlas)
    both("gaussian_blur", image.gaussian_blur, img)
    both("blur (the extractor's fused order, atlas)", lambda a: image._blur(a, 7, 2.0, True),
         atlas)
    m = tuple(t.clone() for t in orb.ic_moment_maps(img))
    both("ic_angles (same moment maps)", lambda im, k, m10, m01: orb.ic_angles(
        im, k, moments=(m10, m01)), img, xy, *m, exact=False, atol=1e-5)
    both("brief_descriptors", orb.brief_descriptors, image.gaussian_blur(img), xy, host_ang)

    X = np.stack([rng.uniform(-3, 3, 1000), rng.uniform(-2, 2, 1000), rng.uniform(0.5, 12, 1000)],
                 1)
    X[:100, 2] *= -1.0  # behind camera 1
    ang = 0.03
    R21 = np.array([[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                    [-np.sin(ang), 0.0, np.cos(ang)]])
    t21 = np.array([-0.3, 0.01, 0.02])
    X2 = X @ R21.T + t21
    X2[100:200] += rng.normal(size=(100, 3)) * 0.5  # bearings off the rays
    b1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    b2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    tri = [torch.from_numpy(np.asarray(v, np.float32)) for v in (X, b1, b2, R21, t21)]
    both("check_triangulation", triangulation.check_triangulation, *tri)
    ok = triangulation.check_triangulation(*tri)
    res["check_triangulation_accepted"] = int(ok.sum())
    gate("public_ops", 0 < int(ok.sum()) < 900, f"check_triangulation accepted {int(ok.sum())}")
    return res


def linalg_checks(device="cuda"):
    """Phase 19 (d): each factorization of ``ops/linalg`` on ``device``
    (the ``torch.linalg`` op) against the CPU (scipy's LAPACK: the
    routines XLA:CPU calls) at its call sites' shapes, on seeded inputs:
    every output within 1e-4 of the CPU output's largest magnitude, the
    singular and eigen vectors up to sign (cuSOLVER picks its own), and a
    Cholesky factor that fails NaN in the same entries on both. Returns
    each check's largest relative difference."""
    from structure_plp_slam_tpu_torch.ops import linalg

    rng = np.random.default_rng(194)
    res = {}

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def spd(n, batch=()):
        a = rand(*batch, n, n + 8)
        return a @ a.transpose(-1, -2) + n * torch.eye(n)

    def spread(*shape):
        """``[..., m, n]`` with singular values k, k - 1, ..., 1 (k = min(m,
        n)): each singular vector well defined to f32's precision."""
        m, n = shape[-2:]
        k = min(m, n)
        q1 = torch.linalg.qr(rand(*shape[:-2], m, m))[0]
        q2 = torch.linalg.qr(rand(*shape[:-2], n, n))[0]
        sv = torch.zeros(*shape)
        sv.diagonal(dim1=-2, dim2=-1).copy_(torch.arange(k, 0, -1, dtype=torch.float32))
        return q1 @ sv @ q2.transpose(-1, -2)

    def aligned(card, host, dim):
        """``card``'s vectors (along ``dim``) turned to ``host``'s signs."""
        s = torch.sign((card * host).sum(dim, keepdim=True))
        return card * torch.where(s == 0, 1.0, s)

    def check(name, fn, *args, vectors=()):
        host = fn(*args)
        card = fn(*(a.to(device) for a in args))
        host = host if isinstance(host, tuple) else (host,)
        card = tuple(c.cpu() for c in (card if isinstance(card, tuple) else (card,)))
        worst = 0.0
        for i, (h, c) in enumerate(zip(host, card, strict=True)):
            nan = torch.isnan(h)
            gate("linalg", torch.equal(nan, torch.isnan(c)),
                 f"{name} output {i}: NaN in other entries on the card")
            if i in vectors:
                c = aligned(c, h, vectors[i])
            h, c = h[~nan], c[~nan]
            if h.numel():
                rel = float((c - h).abs().max() / h.abs().max().clamp(min=1e-30))
                gate("linalg", rel <= 1e-4, f"{name} output {i}: {rel:.3e} off the CPU")
                worst = max(worst, rel)
        res[name] = worst
        print(f"linalg {name}: card within {worst:.3e} of the CPU (relative to its largest)")

    # The 8-point rows (256 minimal sets), E's projection and
    # decomposition, the 12x12 PnP rows, the 9x9 weighted refit.
    for name, shape in (("svd [256,8,9]", (256, 8, 9)), ("svd [256,3,3]", (256, 3, 3)),
                        ("svd [3,3]", (3, 3)), ("svd [256,12,12]", (256, 12, 12))):
        check(name, lambda a: linalg.svd(a, full_matrices=True), spread(*shape),
              vectors={0: -2, 2: -1})
    for name, shape in (("eigh [9,9]", (9, 9)), ("eigh [1032,4,4]", (1032, 4, 4))):
        a = spread(*shape)
        check(name, linalg.eigh, a @ a.transpose(-1, -2), vectors={1: -2})
    for n in (24, 192, 384):  # the BA's, global BA's and pose graph's camera systems
        check(f"cho_factor/cho_solve {n}",
              lambda a, b: (linalg.cho_factor(a), linalg.cho_solve(linalg.cho_factor(a), b)),
              spd(n), rand(n))
    bad = torch.diag(torch.tensor([1.0, -1.0, 2.0, 3.0]))
    check("cho_factor not positive definite", linalg.cho_factor, bad)
    check("block_cholesky_solve [32,32,6,6]", linalg.block_cholesky_solve,
          spd(192).reshape(32, 6, 32, 6).permute(0, 2, 1, 3).contiguous(), rand(32, 6))
    check("inv [32768,3,3]", linalg.inv, spd(3, (32768,)))  # the global BA's landmark blocks
    check("solve [1024,4,4]", linalg.solve, spd(4, (1024,)), rand(1024, 4))  # line BA
    check("solve [6,6]", linalg.solve, spd(6), rand(6))  # the line tracker's
    check("det3 [256,3,3]", linalg.det3, rand(256, 3, 3))
    return res


@functools.lru_cache(maxsize=None)
def _system_ba_calls(setup="mono"):
    """The monocular System's init BA and first keyframe chain BA on the CPU
    (640x480, 1000 keypoints over 8 levels, numpy seed 42, phase 7's
    capacities): ``{"init": ..., "chain": ...}``, each the ``mapper.local_ba``
    call's (camera, state, slot, inverse sigmas) and keywords, copied when
    the call was made. ``setup="rgbd"``: the main path's RGB-D System at
    the same width and capacities (its camera, focal_x_baseline 40, and
    ``make_sequence``'s 0.06 m a frame), whose first chain is the only call."""
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.data import map_state
    from structure_plp_slam_tpu_torch.models import mapper
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    rgbd = setup == "rgbd"
    depth = dict(focal_x_baseline=40.0, depth_threshold=40.0, depthmap_factor=1.0) if rgbd else {}
    cam = Camera(name="b", setup=CameraSetup.RGBD if rgbd else CameraSetup.MONOCULAR,
                 model=CameraModel.PERSPECTIVE, cols=640, rows=480, fx=525.0, fy=525.0,
                 cx=319.5, cy=239.5, fps=30.0, **depth)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 12,
                                              step=0.06 if rgbd else 0.08)
    want = ("chain",) if rgbd else ("init", "chain")
    calls = {}
    local_ba = mapper.local_ba

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def record(camera, state, slot, isg, **k):
        if k.get("_xla") in ("init", "chain") and k["_xla"] not in calls:
            st = map_state.from_numpy(map_state.to_numpy(state), "cpu")
            calls[k["_xla"]] = ((camera, st, slot, isg.clone()),
                                {n: clone(v) for n, v in k.items()})
        return local_ba(camera, state, slot, isg, **k)

    slam = System(Config(camera=cam, orb=OrbParams(max_num_keypts=1000, num_levels=8), raw={}),
                  device="cpu", enable_loop_closing=False, max_keyframes=32,
                  max_landmarks=8192, max_kf_interval=3)
    mapper.local_ba = record
    try:
        slam.startup()
        for img, depth, ts in frames:
            if rgbd:
                slam.feed_RGBD_frame(img, depth, ts)
            else:
                slam.feed_monocular_frame(img, ts)
            if len(calls) == len(want):
                break
        slam.shutdown()
    finally:
        mapper.local_ba = local_ba
    return calls


def _ba_card_vs_cpu(name, call, device):
    """One recorded ``local_ba`` call on the CPU (its C route) and on
    ``device`` (the PyTorch iteration there): the largest pose and point
    differences, the share of equal associations and how far the CPU solve
    moved the poses; gated at 1e-4 / 1e-3 m / 99%."""
    from structure_plp_slam_tpu_torch.data import map_state
    from structure_plp_slam_tpu_torch.models import mapper

    (camera, state, slot, isg), kw = call
    host = map_state.to_numpy(mapper.local_ba(camera, state, slot, isg, **kw)[0])
    card_kw = {k: v.to(device) if torch.is_tensor(v) else v for k, v in kw.items()}
    card_state = map_state.from_numpy(map_state.to_numpy(state), device)
    card = map_state.to_numpy(
        mapper.local_ba(camera, card_state, slot, isg.to(device), **card_kw)[0])
    moved = float(np.abs(host["kf_pose"] - map_state.to_numpy(state)["kf_pose"]).max())
    res = {"pose_abs": float(np.abs(card["kf_pose"] - host["kf_pose"]).max()),
           "points_abs": float(np.abs(card["lm_pos"] - host["lm_pos"]).max()),
           "obs_equal_share": float((card["kf_lm_idx"] == host["kf_lm_idx"]).mean()),
           "pose_moved": moved, "slot": int(slot)}
    print(f"{name} (640x480, seed 42, keyframe {slot}): card against the CPU's XLA:CPU "
          f"iteration: {res}")
    gate(name, res["pose_abs"] < 1e-4 and res["points_abs"] < 1e-3
         and res["obs_equal_share"] >= 0.99 and moved > 0, f"{res}")
    return res


def init_ba_checks(device="cuda"):
    """Phase 19 (e): the two CPU routes this repository computes as XLA:CPU
    does, each on the card against the CPU. (1) The monocular System's
    two-view BA after its init (640x480, 1000 keypoints over 8 levels,
    numpy seed 42, the capacities of phase 7's full-width System): its
    first ``mapper.local_ba`` call's input, recorded on a CPU System
    (``_system_ba_calls``), through ``local_ba(..., _xla="init")`` on the card
    (the PyTorch iteration) and on the CPU (``ops/ba_cpu``'s C source):
    poses within 1e-4, points within 1e-3 m (the mapper tests' bounds), the
    detached observations equal on >= 99% of slots. (2) ``match_stereo`` on phase 8 (b)'s first
    pair at each dataset camera, with the CPU extractor's features on both:
    masks equal, x_right within 1e-3 px, depth within 1e-4 relative (the SAD
    sums: XLA:CPU's tree order on the CPU, ``torch.sum`` on the card).
    Returns each check's largest difference."""
    from structure_plp_slam_tpu_torch.ops import matching, stereo
    from structure_plp_slam_tpu_torch.ops.orb import OrbExtractor, OrbParams

    res = {}
    calls = _system_ba_calls()
    if "init" not in calls:
        raise AssertionError("phase 19 (e): the monocular System ran no init BA")
    res["init_ba"] = _ba_card_vs_cpu("init_ba", calls["init"], device)

    for name in DATASET_CAMERAS:
        scam = dataset_config(name).camera
        left, right, _ = dataset_pairs(scam, 1)[0][0]
        n_kps = dataset_config(name).orb.max_num_keypts
        ex = OrbExtractor(scam.rows, scam.cols, OrbParams(max_num_keypts=n_kps, num_levels=8))
        gl, gr = (torch.from_numpy(np.ascontiguousarray(i, dtype=np.float32))
                  for i in (left, right))
        fl, fr = ex(gl), ex(gr)
        sf = torch.from_numpy(ex.params.scale_factors().astype(np.float32))
        args = [gl, gr, fl["xy"], fl["level"], matching.unpack_desc_bits(fl["desc"]),
                fl["valid"], fr["xy"], fr["level"], matching.unpack_desc_bits(fr["desc"]),
                fr["valid"], sf]
        xh, dh, okh = stereo.match_stereo(*args, focal_x_baseline=scam.focal_x_baseline)
        xc, dc, okc = (t.cpu() for t in stereo.match_stereo(
            *(a.to(device) for a in args), focal_x_baseline=scam.focal_x_baseline))
        r = res[f"match_stereo {name}"] = {
            "matched": int(okh.sum()), "x_right_abs": float((xh - xc).abs().max()),
            "depth_rel": float(((dh - dc).abs()[okh] / dh[okh]).max()) if bool(okh.any()) else 0.0}
        print(f"match_stereo ({name}): card against the CPU: {r}")
        gate("init_ba", torch.equal(okh, okc) and r["matched"] > 300 and r["x_right_abs"] < 1e-3
             and r["depth_rel"] < 1e-4, f"match_stereo {name}: {r}")
    return res


def chain_ba_checks(device="cuda"):
    """Phase 19 (f): the monocular keyframe chain's local BA on the card
    against the CPU. The CPU System of phase 19 (e) (``_system_ba_calls``)
    runs on to its first keyframe chain after the init; that chain's
    ``mapper.local_ba`` call (``_xla="chain"``, C = 32 window cameras) runs
    again on the card (the PyTorch iteration) and on the CPU
    (``ops/ba_cpu``'s C source, XLA:CPU's arithmetic): poses within 1e-4,
    points within 1e-3 m, the detached observations equal on >= 99% of
    slots. Returns the largest differences."""
    calls = _system_ba_calls()
    if "chain" not in calls:
        raise AssertionError("phase 19 (f): the monocular System ran no keyframe chain BA")
    return _ba_card_vs_cpu("chain_ba", calls["chain"], device)


def rgbd_chain_ba_checks(device="cuda"):
    """Phase 19 (g): the RGB-D keyframe chain's local BA on the card against
    the CPU. The main path's RGB-D System (640x480, 1000 keypoints over 8
    levels, numpy seed 42, 32 keyframes and 8192 landmarks, so a 32-camera
    window) runs on the CPU to its first keyframe chain with a local BA
    (``_system_ba_calls("rgbd")``); that call (``_xla="chain"``, stereo rows
    from the depth) runs again on the card (the PyTorch iteration) and on
    the CPU (``ops/ba_cpu``'s C source, XLA:CPU's 3-row arithmetic): poses
    within 1e-4, points within 1e-3 m, the detached observations equal on
    >= 99% of slots (phase 19 (f)'s bounds). The card's sums run in fixed
    orders (deterministic()): this first window's BA moves points by up to
    4 m in its 8 iterations, and follows the order of the card's segment
    sums, which otherwise changes on every run (points 2.3e-4 to 1.4e-3 m
    from the CPU's over four runs of one code; 2.7e-4 m on each of three
    with fixed orders; PERF.md §6). Returns the largest differences
    and the share of stereo rows in the window."""
    calls = _system_ba_calls("rgbd")
    if "chain" not in calls:
        raise AssertionError("phase 19 (g): the RGB-D System ran no keyframe chain BA")
    (_, state, slot, _), _ = calls["chain"]
    with deterministic():
        res = _ba_card_vs_cpu("rgbd_chain_ba", calls["chain"], device)
    kp = state.kf_kp_valid[slot] & (state.kf_lm_idx[slot] >= 0)
    res["stereo_share"] = float((state.kf_xr[slot][kp] >= 0).float().mean())
    gate("rgbd_chain_ba", res["stereo_share"] > 0.5, f"stereo share {res['stereo_share']}")
    return res


def knob_checks(cam, slam, frames, device="cuda"):
    """Phase 19 (b): public parameters the JAX package takes and the port
    now takes too, each at a non-default value on the card against the
    same call on the CPU at the main path's shapes: essential_ransac
    (num_hypotheses=64), sim3_ransac (fix_scale=True), match_stereo
    (window=7, patch=3) on a rendered 640x480 pair, and a Relocalizer
    (min_inliers=30) on phase 4's map with frame 20's features. The
    bounds of the CPU parity tests (tests/test_torch_api_parity.py).
    Returns each check's numbers."""
    import dataclasses

    from structure_plp_slam_tpu_torch.camera import CameraSetup
    from structure_plp_slam_tpu_torch.data import bow, map_state
    from structure_plp_slam_tpu_torch.models import relocalizer
    from structure_plp_slam_tpu_torch.ops import matching, ransac, sim3_solver, stereo
    from structure_plp_slam_tpu_torch.testing import synthetic_scene
    from structure_plp_slam_tpu_torch.utils import prng

    rng = np.random.default_rng(191)
    res = {}

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    # Two views of a random cloud, 20% of the second view's bearings off.
    n = 400
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    X2 = X @ R.T + np.array([0.5, -0.05, 0.02])
    X2[:80] += rng.normal(size=(80, 3))
    b1 = torch.from_numpy((X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32))
    b2 = torch.from_numpy((X2 / np.linalg.norm(X2, axis=1, keepdims=True)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=n) < 0.95)
    out = {d: ransac.essential_ransac(*on(d, b1, b2, valid), prng.PRNGKey(5, device=d),
                                      num_hypotheses=64) for d in ("cpu", device)}
    Eh, Ec = out["cpu"][0], out[device][0].cpu()
    rel = min(float((Ec - Eh).abs().max()), float((Ec + Eh).abs().max())) / float(Eh.abs().max())
    same = float((out["cpu"][1] == out[device][1].cpu()).double().mean())
    res["essential_ransac num_hypotheses=64"] = {"E_rel": rel, "inliers_equal": same}
    gate("knobs", rel < 1e-3 and same >= 0.99, f"essential_ransac: E {rel:.2e}, masks {same}")

    # A rigid motion (scale 1) between two keyframes' landmark sets.
    P1 = X.astype(np.float32)
    P2 = (X @ R.T + np.array([0.4, -0.2, 0.6])).astype(np.float32)

    def proj(P):
        return np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                         cam.fy * P[:, 1] / P[:, 2] + cam.cy], 1).astype(np.float32)

    uv1, uv2 = proj(P1), proj(P2)
    P2[:60] += rng.normal(scale=2.0, size=(60, 3)).astype(np.float32)
    sig = np.ones(n, np.float32)
    args = [torch.from_numpy(a) for a in (P1, P2, uv1, uv2, sig, sig)] + [valid]
    out = {d: sim3_solver.sim3_ransac(cam, *on(d, *args), prng.PRNGKey(3, device=d),
                                      num_hypotheses=64, fix_scale=True) for d in ("cpu", device)}
    h, c = out["cpu"], [t.cpu() for t in out[device]]
    dR, dt = float((h[0] - c[0]).abs().max()), float((h[1] - c[1]).abs().max())
    res["sim3_ransac fix_scale=True"] = {"s": [float(h[2]), float(c[2])], "inliers": int(c[4]),
                                         "R_abs": dR, "t_abs": dt}
    gate("knobs", float(h[2]) == float(c[2]) == 1.0 and int(h[4]) == int(c[4]) > 100
         and torch.equal(h[3], c[3]) and max(dR, dt) < 1e-4,
         f"sim3_ransac fix_scale: {res['sim3_ransac fix_scale=True']}")

    # A stereo pair at the main path's width; the CPU's features on both.
    baseline = 0.1
    st_cam = dataclasses.replace(cam, setup=CameraSetup.STEREO, focal_x_baseline=cam.fx * baseline)
    tex = synthetic_scene.make_texture(np.random.default_rng(8))
    Rp, tp = synthetic_scene.trajectory(3)[1]
    left, _ = synthetic_scene.render(st_cam, tex, Rp, tp)
    right, _ = synthetic_scene.render(st_cam, tex, Rp, tp - np.array([baseline, 0.0, 0.0]))
    ex = slam.frontend.extractor
    gl, gr = (torch.from_numpy(np.ascontiguousarray(i, dtype=np.float32)) for i in (left, right))
    fl, fr = ex(gl), ex(gr)
    sf = torch.from_numpy(ex.params.scale_factors().astype(np.float32))
    sargs = [gl, gr, fl["xy"], fl["level"], matching.unpack_desc_bits(fl["desc"]), fl["valid"],
             fr["xy"], fr["level"], matching.unpack_desc_bits(fr["desc"]), fr["valid"], sf]
    out = {d: stereo.match_stereo(*on(d, *sargs), focal_x_baseline=st_cam.focal_x_baseline,
                                  window=7, patch=3) for d in ("cpu", device)}
    (xh, dh, okh), (xc, dc, okc) = out["cpu"], [t.cpu() for t in out[device]]
    dx = float((xh - xc).abs().max())
    ddep = float(((dh - dc).abs()[okh] / dh[okh]).max()) if bool(okh.any()) else 0.0
    res["match_stereo window=7 patch=3"] = {"matched": int(okh.sum()), "x_right_abs": dx,
                                           "depth_rel": ddep}
    gate("knobs", torch.equal(okh, okc) and int(okh.sum()) > 200 and dx < 1e-3 and ddep < 1e-4,
         f"match_stereo: {res['match_stereo window=7 patch=3']}")

    # The relocalizer with a stricter acceptance on phase 4's map.
    img, depth, _ = frames[20]
    feats = slam.frontend.rgbd(img, depth)
    host_state = map_state.from_numpy(map_state.to_numpy(slam.state), "cpu")
    out = {}
    for d, st in (("cpu", host_state), (device, slam.state)):
        reloc = relocalizer.Relocalizer(cam, bow.BowIndex(), min_inliers=30)
        out[d] = reloc.relocalize(st, {k: v.to(d) for k, v in feats.items()},
                                  slam.frontend.inv_sigma_sq.to(d), prng.PRNGKey(11, device=d))
    h, c = out["cpu"], out[device]
    if h is None or c is None:
        raise AssertionError(f"Relocalizer(min_inliers=30): CPU {h is not None}, card "
                             f"{c is not None}")
    dR, dt = float((h[0] - c[0].cpu()).abs().max()), float((h[1] - c[1].cpu()).abs().max())
    assoc = float((h[2] == c[2].cpu()).double().mean())
    res["Relocalizer min_inliers=30"] = {"kf": [h[3], c[3]], "R_abs": dR, "t_abs": dt,
                                         "associations_equal": assoc}
    gate("knobs", h[3] == c[3] and max(dR, dt) < 1e-3 and assoc >= 0.99,
         f"Relocalizer: {res['Relocalizer min_inliers=30']}")
    for k, v in res.items():
        print(f"knob {k}: card against CPU {v}")
    return res


def line_z(slam):
    """Valid line endpoints (world) and their z coordinates."""
    st = slam.state
    eps = st.ln_endpoints[st.ln_valid].cpu().numpy()
    return eps, np.concatenate([eps[:, 2], eps[:, 5]])


def near_planes(z, tol):
    """Share of ``z`` within ``tol`` of the scene's planes (z = 3.5, 6)."""
    return float(((np.abs(z - 6.0) < tol) | (np.abs(z - 3.5) < tol)).mean()) if len(z) else 0.0


def plp_paths(fm, cam, cfg, N, capacities=(256, 32768)):
    """Phase 12: point + line + plane SLAM at the main path's width and
    capacities, on the grid-textured scene (numpy seed 0) with the JAX
    tests' gates (tests/test_line_system.py, tests/test_planes.py,
    tests/test_stereo_line_system.py):

    (a) plp: RGB-D, lines on, loop closing on (the default), every frame
        with the instance mask np.where(depth < 4.5, 1, 2), 24 frames at
        0.06 m a frame, max_kf_interval=PLP_KF_INTERVAL; then 4 of the
        same frames under torch.profiler and one frame under the sync
        debug mode;
    (b) mono_lines: monocular, lines on, 16 frames at 0.08 m a frame,
        max_kf_interval=3, fixed sums (deterministic()), the texture of
        test_mono_point_line_slam (numpy seed 42): gated at that test's
        320x240 configuration, and driven at the main path's width too
        (mono_lines_full, 8 frames, reported: ROADMAP C17);
    (c) stereo_lines: stereo (0.1 m baseline), lines on, 16 frames,
        max_kf_interval=2, test_stereo_point_line_slam's texture (seed
        42): two-view line triangulation and the stereo endpoint depths
        on the card.
    Returns each path's numbers."""
    import dataclasses

    from structure_plp_slam_tpu_torch.camera import CameraSetup
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    runs = {}
    mono_cam = dataclasses.replace(cam, setup=CameraSetup.MONOCULAR, focal_x_baseline=0.0)
    textures = {seed: synthetic_scene.make_texture(np.random.default_rng(seed), grid=True)
                for seed in (0, 42)}

    def render(c, n, step, baseline=None, seed=0):
        tex = textures[seed]
        poses = synthetic_scene.trajectory(n, step=step)
        frames = []
        for i, (R, t) in enumerate(poses):
            img, depth = synthetic_scene.render(c, tex, R, t)
            other = np.where(depth < 4.5, 1, 2).astype(np.int32)
            if baseline is not None:
                other, _ = synthetic_scene.render(c, tex, R, t - np.array([baseline, 0.0, 0.0]))
            frames.append((img, depth, other, float(i) / 30.0))
        return frames, poses

    def system(config, verbose_timing=True, **kw):
        return System(config, max_keyframes=capacities[0], max_landmarks=capacities[1],
                      with_lines=True, verbose_timing=verbose_timing, device="cuda", **kw)

    def recorder():
        return SiteRecorder(fm, tracker, mapper, N)

    def line_stages(r, stages):
        r["line_stage_median_ms"] = {k: r["stage_median_ms"].get(k) for k in stages}
        r["line_stage_count"] = {k: r["stage_count"].get(k, 0) for k in stages}

    # ---- (a) RGB-D points + lines + planes ------------------------------
    frames, poses = render(cam, PLP_FRAMES, 0.06)
    plp_feed = lambda s, f: s.feed_RGBD_frame(f[0], f[1], f[3], seg_mask=f[2])  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    slam = system(cfg, max_kf_interval=PLP_KF_INTERVAL)
    r = drive_path("plp", fm, recorder(), slam, plp_feed, frames)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    st = slam.state
    eps, z = line_z(slam)
    pv = st.pl_valid.cpu().numpy()
    coefs = st.pl_coef.cpu().numpy()[pv]
    planes_ok = [bool(abs(c[2]) > 0.98 and min(abs(abs(c[3]) - 3.5), abs(abs(c[3]) - 6.0)) < 0.3)
                 for c in coefs]
    owned = int(((st.lm_plane >= 0) & st.lm_valid).sum())
    r["gates"] = {"ate_m": ate, "kf_interval": PLP_KF_INTERVAL,
                  "lines_created": int(slam.next_line),
                  "lines_valid": int(len(eps)), "line_endpoints_near_planes": near_planes(z, 0.4),
                  "planes": int(pv.sum()), "plane_coefs": coefs.tolist(), "planes_ok": planes_ok,
                  "plane_owned_landmarks": owned, "peak_mib": peak_mib}
    line_stages(r, ("frontend.lines", "track.lines", "keyframe.lines", "keyframe.planes"))
    print(f"path plp: ATE {ate:.6f} m; lines created {int(slam.next_line)}, valid {len(eps)}, "
          f"endpoints near the planes {r['gates']['line_endpoints_near_planes']:.4f}; planes "
          f"{int(pv.sum())} {coefs.tolist()}; plane-owned landmarks {owned}; peak "
          f"torch.cuda.max_memory_allocated {peak_mib:.1f} MiB; line/plane stage medians "
          f"{r['line_stage_median_ms']} (counts {r['line_stage_count']})")
    gate("plp", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("plp", ate < 0.06, f"ATE {ate} >= 0.06 m")
    gate("plp", int(slam.next_line) >= 4 and len(eps) >= 4, f"{len(eps)} lines")
    gate("plp", r["gates"]["line_endpoints_near_planes"] > 0.6, f"line endpoints off-plane: {z}")
    gate("plp", pv.sum() >= 1 and all(planes_ok), f"planes {coefs.tolist()}")
    gate("plp", owned > 30, f"{owned} plane-owned landmarks")
    gate("plp", all(r["line_stage_count"].values()), "a line or plane stage never ran")
    # Two traced frames (one keyframe chain at the interval of 2): each
    # traced frame costs ~15 s of event parsing on the host.
    r["profile"] = profile_frames(
        lambda verbose_timing: system(cfg, verbose_timing, max_kf_interval=PLP_KF_INTERVAL),
        frames, warm=4, count=2, feed=plp_feed, label="profile plp")
    r["syncs_per_frame"] = count_syncs(
        lambda: system(cfg, False, max_kf_interval=PLP_KF_INTERVAL), frames, plp_feed)
    # The default-off surfaces (publishers, autosave, viewers) add none.
    gate("plp", r["syncs_per_frame"]["total"] <= MAX_PLP_SYNCS,
         f"{r['syncs_per_frame']['total']} host syncs per frame > {MAX_PLP_SYNCS}")
    runs["plp"] = r

    # ---- (b) monocular points + lines -------------------------------------
    # Gated at test_mono_point_line_slam's own configuration (320x240,
    # 600 keypoints over 4 levels, K = 32, L = 8192); at the main path's
    # width reported only (ROADMAP C17): the card's angles are CUDA's
    # atan2f, within 2 ulp of the CPU's, and the two-view init turns on
    # single area matches; tests/test_torch_plp_system.py's slow test
    # holds the CPU run against the JAX System.
    small = dataclasses.replace(mono_cam, cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5,
                                cy=119.5)
    for name, c, orb, caps, gated, n_frames in (
            ("mono_lines", small, OrbParams(max_num_keypts=600, num_levels=4), (32, 8192), True,
             LINE_FRAMES),
            ("mono_lines_full", mono_cam, cfg.orb, capacities, False, REPORTED_LINE_FRAMES)):
        frames, poses = render(c, n_frames, 0.08, seed=42)
        slam = System(dataclasses.replace(cfg, camera=c, orb=orb), max_keyframes=caps[0],
                      max_landmarks=caps[1], with_lines=True, verbose_timing=True,
                      device="cuda", max_kf_interval=3, enable_loop_closing=False)
        with deterministic():
            r = drive_path(name, fm, SiteRecorder(fm, tracker, mapper, slam.frontend.pad_to),
                           slam, lambda s, f: s.feed_monocular_frame(f[0], f[3]), frames)
        ate = ate_of(traj_io, slam, poses, align_scale=True)
        # The map Sim3-aligned to ground truth through the camera centres
        # (paired by timestamp: the trajectory starts at the two-view init).
        est = slam.frame_trajectory()
        A = np.stack([-P[:, :3].T @ P[:, 3] for _, P in est])
        B = np.stack([-poses[round(ts * 30)][0].T @ poses[round(ts * 30)][1] for ts, _ in est])
        mA, mB = A.mean(0), B.mean(0)
        U, D, Vt = np.linalg.svd((B - mB).T @ (A - mA) / len(A))
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R_al = U @ S @ Vt
        s_al = np.trace(np.diag(D) @ S) / ((A - mA) ** 2).mean(0).sum()
        t_al = mB - s_al * R_al @ mA
        eps, _ = line_z(slam)
        pts = np.concatenate([eps[:, :3], eps[:, 3:]])
        z = (s_al * (R_al @ pts.T)).T[:, 2] + t_al[2]
        r["gates"] = {"gated": gated, "width": c.cols, "ate_sim3_m": ate,
                      "first_trajectory_frame": round(est[0][0] * 30),
                      "lines_created": int(slam.next_line), "lines_valid": int(len(eps)),
                      "line_endpoints_near_planes": near_planes(z, 0.5)}
        line_stages(r, ("frontend.lines", "track.lines", "keyframe.lines"))
        print(f"path {name}: {c.cols}x{c.rows}, Sim3-aligned ATE {ate:.6f} m, trajectory from "
              f"frame {r['gates']['first_trajectory_frame']}; lines created "
              f"{int(slam.next_line)}, valid {len(eps)}, endpoints near the planes "
              f"{r['gates']['line_endpoints_near_planes']:.4f}; line stage medians "
              f"{r['line_stage_median_ms']}{'' if gated else ' (reported, not gated)'}")
        runs[name] = r
    r = runs["mono_lines"]
    gate("mono_lines", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("mono_lines", r["gates"]["ate_sim3_m"] < 0.08,
         f"Sim3 ATE {r['gates']['ate_sim3_m']} >= 0.08 m")
    gate("mono_lines", r["gates"]["lines_created"] >= 3,
         f"{r['gates']['lines_created']} lines created")
    gate("mono_lines", r["gates"]["line_endpoints_near_planes"] > 0.6, "lines off the planes")

    # ---- (c) stereo points + lines ------------------------------------------
    baseline = 0.1
    st_cam = dataclasses.replace(cam, setup=CameraSetup.STEREO, focal_x_baseline=cam.fx * baseline)
    frames, poses = render(st_cam, LINE_FRAMES, 0.06, baseline=baseline, seed=42)
    slam = system(dataclasses.replace(cfg, camera=st_cam), max_kf_interval=2,
                  enable_loop_closing=False)
    r = drive_path("stereo_lines", fm, recorder(), slam,
                   lambda s, f: s.feed_stereo_frame(f[0], f[2], f[3]), frames)
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    eps, z = line_z(slam)
    r["gates"] = {"ate_m": ate, "lines_created": int(slam.next_line), "lines_valid": int(len(eps)),
                  "line_endpoints_near_planes": near_planes(z, 0.5)}
    line_stages(r, ("frontend.lines", "track.lines", "keyframe.lines"))
    print(f"path stereo_lines: ATE {ate:.6f} m; lines created {int(slam.next_line)}, valid "
          f"{len(eps)}, endpoints near the planes {r['gates']['line_endpoints_near_planes']:.4f}; "
          f"line stage medians {r['line_stage_median_ms']}")
    gate("stereo_lines", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("stereo_lines", int(slam.next_line) >= 4 and len(eps) >= 4, f"{len(eps)} lines")
    gate("stereo_lines", r["gates"]["line_endpoints_near_planes"] > 0.6, f"lines off-plane: {z}")
    gate("stereo_lines", ate < 0.06, f"ATE {ate} >= 0.06 m")
    gate("stereo_lines", r["landmarks"] > 200, f"{r['landmarks']} landmarks")
    runs["stereo_lines"] = r
    return runs


def fisheye_path(fm, cfg, capacities=(256, 32768)):
    """Phase 14: RGB-D through a Kannala-Brandt fisheye at full width:
    tests/test_fisheye_system.py's camera scaled x2 (640x480, fx = fy =
    480, k1..k4 = -0.05, 0.01, -0.003, 0.001), FISHEYE_FRAMES frames of the
    port's fisheye renderer at 0.05 m a frame (numpy seed 0), the default
    keyframe interval (ROADMAP C15), loop closing on (the default). Gates:
    TRACKING, ATE < 0.06 m (that test's bound), and drive_path's: every
    matcher call launched the kernel, equal to its plain twin. Then 2
    frames under torch.profiler (each traced frame costs ~15 s of event
    parsing on the host)."""
    import dataclasses

    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cam = Camera(name="fisheye", setup=CameraSetup.RGBD, model=CameraModel.FISHEYE, cols=640,
                 rows=480, fx=480.0, fy=480.0, cx=319.5, cy=239.5, fps=30.0, k1=-0.05,
                 k2=0.01, k3=-0.003, k4=0.001, focal_x_baseline=48.0, depth_threshold=400.0)
    config = dataclasses.replace(cfg, camera=cam)
    tex = synthetic_scene.make_texture(np.random.default_rng(0))
    poses = synthetic_scene.trajectory(FISHEYE_FRAMES, step=0.05)
    frames = [(*synthetic_scene.render_fisheye(cam, tex, R, t), float(i) / 30.0)
              for i, (R, t) in enumerate(poses)]

    def make_system(verbose_timing=True):
        return System(config, max_keyframes=capacities[0], max_landmarks=capacities[1],
                      verbose_timing=verbose_timing, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    slam = make_system()
    r = drive_path("fisheye", fm, SiteRecorder(fm, tracker, mapper, slam.frontend.pad_to), slam,
                   lambda s, f: s.feed_RGBD_frame(f[0], f[1], f[2]), frames)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    r["gates"] = {"ate_m": ate, "peak_mib": peak_mib}
    print(f"path fisheye: ATE {ate:.6f} m; peak torch.cuda.max_memory_allocated "
          f"{peak_mib:.1f} MiB")
    gate("fisheye", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("fisheye", r["tracked"] >= FISHEYE_FRAMES - 1,
         f"tracked {r['tracked']} of {FISHEYE_FRAMES}")
    gate("fisheye", ate < 0.06, f"ATE {ate} >= 0.06 m")
    r["profile"] = profile_frames(make_system, frames, warm=4, count=2, label="profile fisheye")
    return r


# OpenVSLAM's example/aist/equirectangular.yaml (RICOH THETA S, 1920x960):
# Feature.mask_rectangles, normalized (x_min, x_max, y_min, y_max).
EQUIRECT_MASK = ((0.0, 1.0, 0.0, 0.1), (0.0, 1.0, 0.84, 1.0), (0.0, 0.2, 0.7, 1.0),
                 (0.8, 1.0, 0.7, 1.0))
EQUIRECT_FRAMES = 16


def equirect_path(fm, capacities=(256, 32768)):
    """Phase 15: monocular equirectangular SLAM at the settings of
    OpenVSLAM's shipped example/aist/equirectangular.yaml (1920x960, 2000
    keypoints over 8 levels at scale factor 1.2, its four mask
    rectangles), EQUIRECT_FRAMES frames of the port's cube room at 0.09 m
    a frame (tests/test_equirect_system.py's texture, numpy seed 42, and
    its max_kf_interval=3), loop closing on (the default), fixed sums
    (deterministic(), ROADMAP C20). The sphere's matches take the masked
    matchers with the u window wrapped, not the kernel (the JAX package's
    routing), so the kernel's launches must be 0 and every masked matcher
    call equal to its CPU run (PlainRecorder). Gates: the map initialized,
    TRACKING, Sim3 ATE < 0.10 m (that test's bound). Then 1 frame under
    torch.profiler."""
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cam = Camera(name="RICOH THETA S 960", setup=CameraSetup.MONOCULAR,
                 model=CameraModel.EQUIRECTANGULAR, cols=1920, rows=960, fps=30.0)
    config = Config(camera=cam, orb=OrbParams(max_num_keypts=2000, scale_factor=1.2,
                                              num_levels=8, ini_fast_thr=20.0,
                                              min_fast_thr=7.0, mask_rects=EQUIRECT_MASK),
                    raw={})
    t0 = time.perf_counter()
    tex = synthetic_scene.make_texture(np.random.default_rng(42))
    poses = synthetic_scene.trajectory(EQUIRECT_FRAMES, step=0.09)
    frames = [(synthetic_scene.render_equirect(cam, tex, R, t)[0], float(i) / 30.0)
              for i, (R, t) in enumerate(poses)]
    print(f"path equirect: {len(frames)} frames rendered in {time.perf_counter() - t0:.1f} s")
    feed = lambda s, f: s.feed_monocular_frame(f[0], f[1])  # noqa: E731

    def make_system(verbose_timing=True):
        return System(config, max_keyframes=capacities[0], max_landmarks=capacities[1],
                      max_kf_interval=3, verbose_timing=verbose_timing, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    slam = make_system()
    with deterministic():
        r = drive_path("equirect", fm, SiteRecorder(fm, tracker, mapper, slam.frontend.pad_to),
                       slam, feed, frames, plain=PlainRecorder())
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    est = slam.frame_trajectory()
    ate = ate_of(traj_io, slam, poses, align_scale=True) if len(est) >= 3 else float("inf")
    first = round(est[0][0] * 30) if est else None
    r["gates"] = {"width": cam.cols, "keypoint_slots": slam.frontend.pad_to,
                  "ate_sim3_m": ate, "trajectory_frames": len(est),
                  "first_trajectory_frame": first, "peak_mib": peak_mib}
    print(f"path equirect: {cam.cols}x{cam.rows}, {slam.frontend.pad_to} keypoint slots, "
          f"Sim3-aligned ATE {ate:.6f} m over {len(est)} trajectory frames from frame {first}; "
          f"peak torch.cuda.max_memory_allocated {peak_mib:.1f} MiB")
    gate("equirect", slam.next_kf >= 2 and est, "the map never initialized")
    gate("equirect", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("equirect", ate < 0.10, f"Sim3 ATE {ate} >= 0.10 m")
    r["profile"] = profile_frames(make_system, frames, warm=3, count=1, feed=feed,
                                  label="profile equirect")
    return r


def rectify_fisheye():
    """Phase 16: ops/rectify.StereoRectifier built from a fisheye node
    (StereoRectifier.model: fisheye and its six K/D/R keys: each raw
    camera turned 0.02 rad about y, Kannala-Brandt k1..k4 per side) for
    the 640x480 rectified camera, on the card and on the CPU; a raw pair
    rendered through those fisheye cameras rectified by both. Gates: the
    maps within 1e-3 px, the images within 1e-3 of 255. Times one pair
    on the card (CUDA events)."""
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.ops.rectify import StereoRectifier
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    def rot(th):
        return np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])

    rect = Camera(name="rect", setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE,
                  cols=640, rows=480, fx=480.0, fy=480.0, cx=319.5, cy=239.5, fps=30.0,
                  focal_x_baseline=48.0, depth_threshold=40.0)
    K_raw = np.array([[500.0, 0, 322.0], [0, 498.0, 236.0], [0, 0, 1.0]])
    D = {"left": [-0.05, 0.01, -0.003, 0.001], "right": [-0.04, 0.008, -0.002, 0.0005]}
    raw = {"StereoRectifier.model": "fisheye",
           "StereoRectifier.K_left": K_raw, "StereoRectifier.K_right": K_raw,
           "StereoRectifier.D_left": D["left"], "StereoRectifier.D_right": D["right"],
           "StereoRectifier.R_left": rot(0.02), "StereoRectifier.R_right": rot(-0.02)}
    tex = synthetic_scene.make_texture(np.random.default_rng(0))
    pair = []
    for side, dx in (("left", 0.0), ("right", -0.1)):
        fe = Camera(name=side, setup=CameraSetup.MONOCULAR, model=CameraModel.FISHEYE, cols=640,
                    rows=480, fx=K_raw[0, 0], fy=K_raw[1, 1], cx=K_raw[0, 2], cy=K_raw[1, 2],
                    k1=D[side][0], k2=D[side][1], k3=D[side][2], k4=D[side][3])
        pair.append(synthetic_scene.render_fisheye(fe, tex, rot(-0.02 if dx else 0.02),
                                                   np.array([dx, 0.0, 0.0]))[0])
    card, host = StereoRectifier(rect, raw, device="cuda"), StereoRectifier(rect, raw, device="cpu")
    map_err = max(float((a.cpu() - b).abs().max()) for a, b in (
        (card.my_l, host.my_l), (card.mx_l, host.mx_l), (card.my_r, host.my_r),
        (card.mx_r, host.mx_r)))
    pair_dev = [torch.from_numpy(a).cuda() for a in pair]
    out_card = [t.cpu() for t in card(*pair_dev)]
    out_host = host(*pair)
    img_err = max(float((a - b).abs().max()) for a, b in zip(out_card, out_host))
    ms_card = time_ms(lambda: card(*pair_dev))
    inside = float((out_card[0] != 0).float().mean())
    out = {"maps_max_abs_px": map_err, "image_max_abs": img_err, "rectify_pair_ms": ms_card,
           "left_inside_share": inside, "card": card_line()}
    print(f"rectify fisheye: maps card vs CPU max {map_err} px, images max {img_err} grey "
          f"levels, {inside:.4f} of the left image inside the raw one; one pair on the card "
          f"{ms_card:.4f} ms (CUDA events); card {out['card']}")
    gate("rectify_fisheye", map_err <= 1e-3, f"maps differ by {map_err} px")
    gate("rectify_fisheye", img_err <= 1e-3 * 255, f"images differ by {img_err}")
    gate("rectify_fisheye", inside > 0.9, f"only {inside} of the image rectified")
    return out


IO_DIR = Path(__file__).resolve().parent / "build" / "io_path"
LOC_START, LOC_FRAMES = 15, 10   # phase 17 (d)
SURFACE_FRAMES = 24               # phase 17 (e)


def io_modules():
    """Phase 17 (a): the modules the I/O slice needs, each by name."""
    import importlib

    missing, versions = [], {}
    for name in ("yaml", "msgpack", "cv2", "PIL"):
        try:
            mod = importlib.import_module(name)
        except ImportError:
            missing.append(name)
            continue
        versions[name] = str(getattr(mod, "__version__", getattr(mod, "version", "")))
    if missing:
        raise AssertionError(f"phase 17: modules missing on this machine: {missing}")
    print(f"io modules: {versions}")
    return versions


def build_native():
    """Phase 17 (b): native/libplpslam_native.so, built with make if it is
    absent (a failed build raises with make's output)."""
    from structure_plp_slam_tpu_torch import native

    built = not os.path.exists(native._LIB_PATH)
    t0 = time.perf_counter()
    native.load()
    out = {"built": built, "s": time.perf_counter() - t0}
    print(f"native library: {'built' if built else 'present'} in {out['s']:.2f} s")
    return out


def write_tum(root, cam, frames, poses, factor=5000.0):
    """A TUM RGB-D layout of ``frames`` under ``root``: rgb/ and depth/
    PNGs (uint8 images, uint16 depth at ``factor`` per metre), rgb.txt,
    depth.txt, groundtruth.txt and an OpenCV-dialect config.yaml with
    1000 keypoints over 8 levels."""
    import cv2

    from structure_plp_slam_tpu_torch.io import trajectory as traj_io

    for sub in ("rgb", "depth"):
        (root / sub).mkdir(parents=True)
    rgb, dep = [], []
    for i, (img, depth, ts) in enumerate(frames):
        cv2.imwrite(str(root / "rgb" / f"{i:04d}.png"), img.astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i:04d}.png"), (depth * factor).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{i:04d}.png")
        dep.append(f"{ts:.6f} depth/{i:04d}.png")
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    traj_io.save_tum(str(root / "groundtruth.txt"),
                     [(ts, np.concatenate([R, t[:, None]], 1))
                      for (_, _, ts), (R, t) in zip(frames, poses)])
    (root / "config.yaml").write_text(
        "%YAML:1.0\n"
        f"Camera.name: {cam.name}\nCamera.setup: RGBD\nCamera.model: perspective\n"
        f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
        f"Camera.cols: {cam.cols}\nCamera.rows: {cam.rows}\nCamera.fps: {cam.fps}\n"
        f"Camera.focal_x_baseline: {cam.focal_x_baseline}\n"
        f"depth_threshold: {cam.depth_threshold}\ndepthmap_factor: {factor}\n"
        "Feature.max_num_keypoints: 1000\nFeature.num_levels: 8\n")


def cli_path(name, fm, N, argv):
    """Run the port's CLI in this process (``run.main(argv)``) inside the
    kernel recorder, with the kernel's counts set to 0 just before; the
    System it builds is kept to read what its structure implies. Returns
    drive_path's numbers, the CLI's JSON line and the System."""
    import io as io_mod

    from structure_plp_slam_tpu_torch import run as run_mod
    from structure_plp_slam_tpu_torch.models import mapper, tracker

    made = []
    make = run_mod._make_system

    def keep(args, cfg):
        made.append(make(args, cfg))
        return made[-1]

    out = io_mod.StringIO()
    recorder = SiteRecorder(fm, tracker, mapper, N)
    run_mod._make_system = keep
    torch.cuda.synchronize()
    fm.reset_counts()
    t0 = time.perf_counter()
    try:
        with recorder, contextlib.redirect_stdout(out):
            run_mod.main(argv)
        torch.cuda.synchronize()
    finally:
        run_mod._make_system = make
    wall = time.perf_counter() - t0
    print(out.getvalue(), end="")
    cli = json.loads(out.getvalue().strip().splitlines()[-1])
    slam = made[0]
    base = (0, 0, 0, 0)  # a fresh System
    run = path_numbers(name, fm, recorder, slam, base, cli["frames"],
                       len(slam.frame_trajectory()), wall)
    run["cli"] = cli
    print(f"path {name} CLI: {wall:.3f} s for {cli['frames']} frames, {run['frames_per_s']:.3f} "
          f"frames/s end to end; feed {1.0 / max(cli['mean_track_time_s'], 1e-9):.3f} frames/s "
          f"(mean feed {cli['mean_track_time_s']} s, median {cli['median_track_time_s']} s)")
    return run, slam


def io_paths(fm, cam, cfg, N, frames, poses, capacities=(256, 32768), device="cuda"):
    """Phase 17: the I/O and viewer surfaces at the main path's width.
    (c) The CLI (``run.main(["tum_rgbd", ...])``) on a TUM RGB-D layout of
    the main path's frames written to disk (640x480, depth PNGs at 5000
    per metre, its YAML): every matcher call launched the kernel and equals
    the plain twin, TRACKING, >= 2 keyframes, the written trajectory's ATE
    against groundtruth.txt < 0.05 m, the HTML export written. (d) The CLI
    localizing LOC_FRAMES frames from frame LOC_START against (c)'s saved
    map, the first seen by the camera turned 180 degrees: the first frame
    relocalized, TRACKING, no keyframe added, the last frame localized and
    every localized centre within 0.08 m of its ground truth; the snapshot's save and load
    timed. (e) A library run of SURFACE_FRAMES frames with autosave every
    2 keyframes, the native publisher with a loopback TCP client, the live
    viewer polled at /map.json and the dense cloud on; each surface
    gated."""
    import shutil
    import socket
    import struct
    import threading
    import urllib.request

    import msgpack

    from structure_plp_slam_tpu_torch.io import map_io
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.system import System, TrackerState

    runs = {}
    shutil.rmtree(IO_DIR, ignore_errors=True)
    tum = IO_DIR / "tum"
    write_tum(tum, cam, frames, poses)
    size = ["--max-keyframes", str(capacities[0]), "--max-landmarks", str(capacities[1]),
            "--device", device]

    # ---- (c) the CLI ------------------------------------------------------
    map_path, html = IO_DIR / "map.msg", IO_DIR / "map.html"
    r, slam = cli_path("cli", fm, N, [
        "tum_rgbd", "-c", str(tum / "config.yaml"), "-d", str(tum), *size,
        "--map-db-out", str(map_path), "--export-map-html", str(html),
        "--frame-traj", str(IO_DIR / "frames.txt"),
        "--keyframe-traj", str(IO_DIR / "keyframes.txt")])
    est = traj_io.load_tum(str(IO_DIR / "frames.txt"))
    gt = traj_io.load_tum(str(tum / "groundtruth.txt"))
    ate = traj_io.ate_rmse(est, gt, align_scale=False)
    html_bytes = html.stat().st_size if html.exists() else 0
    r["gates"] = {"ate_m": ate, "trajectory_rows": len(est), "html_bytes": html_bytes}
    print(f"path cli: ATE {ate:.6f} m over {len(est)} rows of the written trajectory; HTML "
          f"{html_bytes} bytes")
    gate("cli", r["state"] == TrackerState.TRACKING.value, f"ended in state {r['state']}")
    gate("cli", r["keyframes"] >= 2, f"{r['keyframes']} keyframes")
    gate("cli", ate < 0.05, f"ATE {ate} >= 0.05 m")
    gate("cli", html_bytes > 1000, "no HTML export")
    # The snapshot's save and load, timed on their own (3 each).
    save_ms, load_ms = [], []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.save_map_database(str(IO_DIR / f"again{k}.msg"))
        save_ms.append((time.perf_counter() - t0) * 1e3)
    fresh = System(slam.config, max_keyframes=capacities[0], max_landmarks=capacities[1],
                   device=device)
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_map_database(str(map_path))
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    mib = map_path.stat().st_size / 2**20
    r["io"] = {"save_ms": float(np.median(save_ms)), "load_ms": float(np.median(load_ms)),
               "snapshot_mib": mib, "save_ms_all": save_ms, "load_ms_all": load_ms}
    print(f"path cli snapshot: {mib:.3f} MiB; save_map_database median {r['io']['save_ms']:.3f} "
          f"ms {save_ms}, load_map_database median {r['io']['load_ms']:.3f} ms {load_ms}")
    runs["cli"] = r
    built = {"keyframes": slam.num_keyframes, "next_kf": slam.next_kf}

    # ---- (d) localization from the saved map ------------------------------
    # Frames LOC_START.. of the same layout; the first seen by the camera
    # turned 180 degrees about its optical axis (phase 9's kidnap: the same
    # centre), which only the relocalizer recovers: from the loaded map's
    # origin the tracker's wide windows would find frame LOC_START as it
    # is at this step.
    import cv2

    loc = IO_DIR / "loc"
    loc.mkdir()
    for txt, sub in (("rgb.txt", "rgb"), ("depth.txt", "depth")):
        rows = [row.split() for row in
                (tum / txt).read_text().strip().splitlines()[LOC_START:LOC_START + LOC_FRAMES]]
        img = cv2.imread(str(tum / rows[0][1]), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(loc / f"{sub}_turned.png"), np.ascontiguousarray(img[::-1, ::-1]))
        (loc / txt).write_text("\n".join([f"{rows[0][0]} {sub}_turned.png"] +
                                         [f"{ts} ../tum/{rel}" for ts, rel in rows[1:]]) + "\n")
    r, lslam = cli_path("localization", fm, N, [
        "tum_rgbd", "-c", str(tum / "config.yaml"), "-d", str(loc), *size,
        "--map-db-in", str(map_path), "--frame-traj", str(IO_DIR / "loc_frames.txt"),
        "--keyframe-traj", str(IO_DIR / "loc_keyframes.txt")])
    traj = lslam.frame_trajectory()
    errs = [float(np.linalg.norm(-P[:, :3].T @ P[:, 3] + poses[round(ts * 30)][0].T
                                 @ poses[round(ts * 30)][1])) for ts, P in traj]
    first_ts = frames[LOC_START][2]
    r["gates"] = {"centre_err_max_m": max(errs, default=float("inf")), "centre_err_m": errs,
                  "first_frame_relocalized": bool(traj) and abs(traj[0][0] - first_ts) < 1e-6
                  and lslam.num_relocalizations >= 1,
                  "keyframes_added": lslam.next_kf - built["next_kf"]}
    print(f"path localization: {len(traj)} of {LOC_FRAMES} frames localized, relocalizations "
          f"{lslam.num_relocalizations} of {r['relocalize_calls']} attempts, first at "
          f"t={traj[0][0] if traj else None}; centre errors {errs}")
    gate("localization", r["gates"]["first_frame_relocalized"],
         "the first frame was not relocalized")
    gate("localization", r["state"] == TrackerState.TRACKING.value, f"ended in {r['state']}")
    gate("localization", r["gates"]["keyframes_added"] == 0
         and r["keyframes"] == built["keyframes"], "a keyframe was added with mapping off")
    # Frames fed while a relocalized frame's decision was pending tracked
    # from the pose before it and are recorded lost (track_lag, as in the
    # JAX System); the frames after them must all localize.
    last_ts = frames[LOC_START + LOC_FRAMES - 1][2]
    gate("localization", errs and max(errs) < 0.08 and abs(traj[-1][0] - last_ts) < 1e-6,
         f"centres off by {errs}, or the last frame not localized")
    runs["localization"] = r

    # ---- (e) the library surfaces -----------------------------------------
    slam = System(cfg, max_keyframes=capacities[0], max_landmarks=capacities[1],
                  verbose_timing=True, store_dense_cloud=True, device=device)
    auto = IO_DIR / "autosave.msg"
    slam.enable_autosave(str(auto), every_n_keyframes=2)
    saved = []
    autosave = slam._maybe_autosave

    def autosave_and_note():
        if slam.next_kf % 2 == 0:
            saved.append({"next_kf": slam.next_kf, "next_lm": int(slam.next_lm),
                          "next_line": int(slam.next_line), "next_plane": int(slam.next_plane)})
        autosave()

    slam._maybe_autosave = autosave_and_note
    cli_sock = socket.create_connection(("127.0.0.1", slam.start_native_publisher()),
                                        timeout=120)
    packets = []

    def receive():
        def exactly(n):
            buf = b""
            while len(buf) < n:
                chunk = cli_sock.recv(n - len(buf))
                if not chunk:
                    return None
                buf += chunk
            return buf
        while True:
            hdr = exactly(4)
            body = hdr and exactly(struct.unpack("!I", hdr)[0])
            if body is None:
                return
            packets.append(msgpack.unpackb(body, raw=False))

    reader = threading.Thread(target=receive, daemon=True)
    reader.start()
    for _ in range(500):
        if slam._native_pub.num_clients >= 1:
            break
        time.sleep(0.01)
    vport = slam.start_live_viewer()
    polls = []

    def poll():
        n_lm = len(slam.get_landmarks())
        n_dense = len(slam.get_map_publisher().get_dense_cloud()[0])
        resp = urllib.request.urlopen(f"http://127.0.0.1:{vport}/map.json", timeout=120)
        data = json.loads(resp.read())
        polls.append({"status": resp.status, "points": len(data["points"]), "landmarks": n_lm,
                      "dense": n_dense, "want": min(n_lm, 20000) + min(n_dense, 20000)})

    def surface_feed(s, item):
        i, (img, depth, ts) = item
        out = s.feed_RGBD_frame(img, depth, ts)
        if i in (SURFACE_FRAMES // 2, SURFACE_FRAMES - 1):
            poll()
        return out

    drawn = {}

    def feed_then_draw(s, item):
        out = surface_feed(s, item)
        if item[0] == SURFACE_FRAMES - 1:
            img = s.get_frame_publisher().draw_frame()
            drawn.update(shape=list(img.shape), dtype=str(img.dtype))
            pts, gray = s.get_map_publisher().get_dense_cloud()
            drawn.update(dense_points=int(len(pts)), dense_gray=int(len(gray)))
        return out

    r = drive_path("surfaces", fm, SiteRecorder(fm, tracker, mapper, N), slam, feed_then_draw,
                   list(enumerate(frames[:SURFACE_FRAMES])))
    final = {"landmarks": r["landmarks"], "keyframes": r["keyframes"]}
    reader.join(timeout=60)
    cli_sock.close()
    loaded = map_io.load_counters(str(auto)) if auto.exists() else None
    state, _ = map_io.load_map_with_counters(str(auto), device) if auto.exists() else (None, None)
    last = packets[-1] if packets else {}
    r["gates"] = {
        "autosave_counters": loaded, "autosaved_at": saved,
        "autosave_keyframes": int(state.kf_valid.sum()) if state is not None else 0,
        "packets": len(packets), "last_packet": {k: last.get(k) for k in
                                                 ("num_landmarks", "num_keyframes")},
        "final": final, "polls": polls, "frame_drawing": drawn,
    }
    r["io"] = {k: r["stage_median_ms"].get(k) for k in ("kf.autosave", "kf.publish", "frontend",
                                                       "track", "keyframe.chain")}
    print(f"path surfaces: autosave file counters {loaded}, autosaved at {saved}; "
          f"{len(packets)} packets, the last {r['gates']['last_packet']}, final {final}; "
          f"/map.json polls {polls}; frame drawing {drawn}")
    print(f"path surfaces stage medians (ms): {r['io']}")
    gate("surfaces", loaded is not None and loaded in saved,
         f"autosave counters {loaded} not among {saved}")
    gate("surfaces", packets and all(len(p["landmarks"]) == 12 * p["num_landmarks"]
                                     for p in packets)
         and last["num_landmarks"] <= final["landmarks"],
         f"native packets {len(packets)}, last {r['gates']['last_packet']}")
    gate("surfaces", len(polls) == 2 and all(p["status"] == 200 and p["points"] == p["want"]
                                             for p in polls), f"/map.json polls {polls}")
    gate("surfaces", drawn.get("shape") == [cam.rows, cam.cols, 3]
         and drawn.get("dtype") == "uint8", f"frame drawing {drawn}")
    gate("surfaces", drawn.get("dense_points", 0) > 0, "empty dense cloud")
    gate("surfaces", r["state"] == TrackerState.TRACKING.value, f"ended in {r['state']}")
    runs["surfaces"] = r
    return runs


def count_syncs(make_system, frames, feed, warm=4):
    """Host synchronizations torch's sync debug mode reports over one fed
    frame after ``warm`` frames (the frame's feed includes whatever
    lagged decision and keyframe chain it triggers)."""
    import warnings

    slam = make_system()
    slam.startup()
    for f in frames[:warm]:
        feed(slam, f)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            feed(slam, frames[warm])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    at = {}
    for w in syncs:
        k = f"{Path(str(w.filename)).name}:{w.lineno}"
        at[k] = at.get(k, 0) + 1
    print(f"sync count plp: {len(syncs)} host synchronizations over one fed frame (gate "
          f"{MAX_PLP_SYNCS}; 61 while the resize operators and the BRIEF pattern were copied to "
          f"the card on every call); by line {at}")
    slam.shutdown()
    return {"total": len(syncs), "at": at}


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device (this script never runs on the CPU)")
    # Before cuBLAS starts: deterministic() needs it for fixed sums.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import structure_plp_slam_tpu_torch  # noqa: F401  (sets TF32 off)
        from structure_plp_slam_tpu_torch.ops import fused_match as fm
    except ImportError as e:
        _fail(f"the port package is not next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = [time.perf_counter()] * 2

    def phase_done(label):
        """Print the wall time of the phases since the last call."""
        now = time.perf_counter()
        print(f"phase time: {label} {now - t_start[1]:.1f} s (script {now - t_start[0]:.1f} s)")
        t_start[1] = now

    # ---- 1. the card ---------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = fm.build(verbose=True)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    # Start CUPTI once before anything is measured: a process's first
    # profiler session can come back empty.
    device_ms(lambda: torch.ones(1024, device="cuda").add_(1), reps=2, warmup=1)

    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io
    from structure_plp_slam_tpu_torch.models import mapper, tracker
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System, TrackerState
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    # bench.py's TUM-like camera; the renderer gives metres.
    cam = Camera(
        name="bench", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
        cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5, fps=30.0,
        focal_x_baseline=40.0, depth_threshold=40.0, depthmap_factor=1.0,
    )
    cfg = Config(camera=cam, orb=OrbParams(max_num_keypts=1000, num_levels=8), raw={})

    def make_system(verbose_timing):  # loop closing on, the default
        return System(cfg, max_keyframes=256, max_landmarks=32768,
                      verbose_timing=verbose_timing, device="cuda")

    slam = make_system(verbose_timing=True)
    N = slam.frontend.pad_to
    rows_by_site = {"track_stage1": N, "track_stage2": min(8192, slam.max_landmarks),
                    "fuse": slam.max_landmarks}

    phase_done("1-2")

    # ---- 3. kernel vs plain on synthetic inputs --------------------------
    rng = np.random.default_rng(0)
    dense, dense_args = {}, {}
    for site, rows in rows_by_site.items():
        args = dense_args[site] = synthetic_inputs(rng, rows, N)
        err = check_exact(fm, args, f"dense {site}")
        t = time_pair(fm, args)
        b_ms, b_by, active, pairs = bound(fm, args)
        tiles = measured_tiles(fm, args)
        yard = bitplane_yardstick_ms(args)
        dense[site] = {"dense_ms": t["kernel_ms"], "dense_records": t["kernel_records"],
                       "dense_plain_ms": t["plain_ms"],
                       "dense_call_ms": t["kernel_call_ms"], "dense_yardstick_ms": yard,
                       "dense_bound_ms": b_ms,
                       "dense_bound_by": b_by, "dense_active_rows": active,
                       "dense_in_window_pairs": pairs, "dense_tiles": tiles}
        print(f"kernel == plain: dense {rows}x{N} ({active} active rows, {pairs} in-window "
              f"pairs; max_abs_err {err}): device kernel {t['kernel_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms ({t['kernel_records']} / {t['plain_records']} records); "
              f"one call {t['kernel_call_ms']:.4f} / {t['plain_call_ms']:.4f} ms; yardstick "
              f"{yard:.5f} ms; bound {b_ms:.6f} ms ({b_by}); tiles {tiles}")
    for kind, L, n in (
        ("masked", 1024, 512),
        ("kp_invalid", 1032, 1032),
        ("radius0", 1032, 777),
        ("ties", 512, 300),
        ("ties", 1032, 1032),               # ties in every strip
        ("ties", 1032, 4196),               # ... and across ring chunks (kResident 2048)
        ("ties_tiles", 100, 333),
        ("dense", 1001, 777),               # ragged: no multiple of a strip, group or tile
        ("dense", 13, 5),
        ("dense", 129, 9),
        ("dense", 32768, 6000),             # above the shared-memory-resident set
    ):
        fm.count_tiles(True)
        err = check_exact(fm, synthetic_inputs(rng, L, n, kind), f"{kind} {L}x{n}")
        tiles = fm.count_tiles(False)
        print(f"kernel == plain: {kind} {L}x{n} (max_abs_err {err}; tiles {tiles})")
        # The counters themselves: no tile without an active row, no mma
        # without a valid keypoint, and every tile to the mma where every
        # keypoint is in every window.
        if kind == "masked" and tiles["walked"] != 0:
            raise AssertionError(f"all rows masked, yet {tiles['walked']} tiles walked")
        if kind == "kp_invalid" and not tiles["mma"] == 0 < tiles["walked"]:
            raise AssertionError(f"no valid keypoint, tiles {tiles}")
        if kind.startswith("ties") and not 0 < tiles["mma"] == tiles["walked"]:
            raise AssertionError(f"{kind}: every tile has a pair in a window, tiles {tiles}")

    phase_done("3")

    # ---- 4. main path at full width --------------------------------------
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(0), cam, NUM_FRAMES)
    stamps, chain_feeds = [], []  # each feed's end; the feeds that ran a keyframe chain

    def main_feed(s, item):
        i, (img, depth, ts) = item
        next_kf = s.next_kf
        out = s.feed_RGBD_frame(img, depth, ts)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if s.next_kf > next_kf and i > 0:
            chain_feeds.append(i)
        return out

    torch.cuda.reset_peak_memory_stats()
    main = SiteRecorder(fm, tracker, mapper, N)
    rgbd = drive_path("rgbd", fm, main, slam, main_feed, list(enumerate(frames)))
    ate = ate_of(traj_io, slam, poses, align_scale=False)
    rgbd["gates"] = {"ate_m": ate}
    launches_by_site = rgbd["site_launches"]
    warm = 5
    print(f"main path: ATE {ate:.6f} m; "
          f"{(NUM_FRAMES - warm) / (stamps[-1] - stamps[warm - 1]):.3f} frames/s after the "
          f"first {warm}; peak torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; keyframe chains ran during "
          f"feeds {chain_feeds}")
    print(f"frontend stage (RGB-D): median {rgbd['stage_median_ms'].get('frontend')} ms on "
          f"{card}; 27.316 ms before the frontend followed XLA:CPU's summation orders (the "
          f"resize as two f32 matmuls, torch.cumsum; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §5)")
    gate("rgbd", rgbd["state"] == TrackerState.TRACKING.value, f"ended in state {rgbd['state']}")
    gate("rgbd", rgbd["tracked"] >= NUM_FRAMES - 1, f"tracked {rgbd['tracked']} of {NUM_FRAMES}")
    gate("rgbd", rgbd["keyframes"] >= 2 and rgbd["landmarks"] > 200,
         "too few keyframes or landmarks")
    gate("rgbd", ate < 0.05, f"ATE {ate} >= 0.05 m")
    expected_rows = {}
    for site, n in launches_by_site.items():
        if n:
            expected_rows[rows_by_site[site]] = expected_rows.get(rows_by_site[site], 0) + n
    gate("rgbd", rgbd["launches_by_rows"] == expected_rows,
         f"launches by row count {rgbd['launches_by_rows']} != {expected_rows} per call site")

    # ---- 5. kernel vs plain on the main path's own inputs -----------------
    # The last call at each site (and the dense fuse-sized input, for
    # compare_fused_match.py) saved on the host, and timed in a fresh process.
    timed = {site: main.inputs_at(site)[-1] for site in rows_by_site}
    timed[f"dense {rows_by_site['fuse']}x{N}"] = dense_args["fuse"]
    torch.save({k: tuple(a.cpu() for a in v) for k, v in timed.items()}, INPUTS)
    times = time_in_child(rows_by_site)

    def kernel_entry(site, args, t, launches, err, dense_site):
        """One call site's entry of the kernels line; ``t`` from
        time_in_child, ``err`` over all the path's calls (drive_path)."""
        rows = args[0].shape[0]
        yard = t["yardstick_ms"]
        bound_ms, bound_by, active, pairs = bound(fm, args)
        tiles = measured_tiles(fm, args)
        print(f"{site}: {rows}x{N} ({active} active rows, {pairs} in-window pairs): device "
              f"kernel {t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms ("
              f"{t['kernel_records']} / {t['plain_records']} records), bf16 bit-plane "
              f"matmul yardstick {yard:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); one call "
              f"{t['kernel_call_ms']:.4f} / {t['plain_call_ms']:.4f} ms; launches "
              f"{launches}; tiles {tiles}")
        return {
            "name": f"fused_match@{site}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": err,
            "ms": t["kernel_ms"],
            "records": t["kernel_records"],
            "plain_ms": t["plain_ms"],
            "call_ms": t["kernel_call_ms"],
            "plain_call_ms": t["plain_call_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "yardstick_ms": yard,
            "yardstick": "torch.matmul of the bf16 ±1 bit planes (distances only)",
            "shape": [rows, N],
            "active_rows": active,
            "in_window_pairs": pairs,
            "design": DESIGN,
            "tiles": tiles,
            "call_site": CALL_SITES[site],
            **dense[dense_site],
        }

    kernels = [kernel_entry(site, timed[site], times[site], launches_by_site[site],
                            rgbd["max_abs_err_by_site"][site], site)
               for site in rows_by_site]

    phase_done("4-5")

    # ---- 6. where the time goes -------------------------------------------
    # Four frames around the second keyframe chain (the first with local
    # BA), which lands on the same feed in a fresh run of the same frames
    # (each traced frame costs ~15 s of event parsing on the host).
    start = chain_feeds[1] - 2 if len(chain_feeds) > 1 else 8
    profile_frames(make_system, frames, warm=start, count=4)

    phase_done("6")

    # ---- 7-10. the monocular, stereo, relocalization and growth paths ----
    runs = {"rgbd": rgbd, **other_paths(fm, cam, cfg, N)}
    phase_done("7-10")

    # ---- 8 (b). the stereo path at the EuRoC and KITTI cameras ---------------
    dataset_runs, kitti_inputs = dataset_stereo_paths(fm)
    runs.update(dataset_runs)
    timed.update(kitti_inputs)
    phase_done("8 (b)")

    # ---- 11. loop closing ---------------------------------------------------
    runs["loop"], loop_args, _ = loop_path(fm, cam, cfg, N)
    timed["loop_fuse"] = loop_args
    torch.save({k: tuple(a.cpu() for a in v) for k, v in timed.items()}, INPUTS)
    child = time_in_child(["loop_fuse", *kitti_inputs])
    kernels.append(kernel_entry(  # the dense synthetic input of fuse's shape beside it
        "loop_fuse", loop_args, child["loop_fuse"],
        runs["loop"]["site_launches"]["loop_fuse"], runs["loop"]["max_abs_err_by_site"]
        .get("loop_fuse", 0.0), "fuse"))
    # The kernel at KITTI's 2,040 keypoint slots (phase 8 (b)'s last call
    # at each tracker site), beside the main path's 1,032 in the kernels line.
    kitti = runs["stereo_kitti"]["kernel_timing"] = {}
    for key, args in kitti_inputs.items():
        t = child[key]
        b_ms, b_by, active, pairs = bound(fm, args)
        kitti[key.split()[1]] = {"shape": list(args[0].shape[:1]) + [args[2].shape[0]],
                                 "active_rows": active, "in_window_pairs": pairs,
                                 "ms": t["kernel_ms"], "records": t["kernel_records"],
                                 "plain_ms": t["plain_ms"], "call_ms": t["kernel_call_ms"],
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "yardstick_ms": t["yardstick_ms"]}
        print(f"{key}: {args[0].shape[0]}x{args[2].shape[0]} ({active} active rows, {pairs} "
              f"in-window pairs): device kernel {t['kernel_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms ({t['kernel_records']} / {t['plain_records']} "
              f"records), yardstick {t['yardstick_ms']:.5f} ms, bound {b_ms:.6f} ms ({b_by}); "
              f"one call {t['kernel_call_ms']:.4f} ms")

    phase_done("11")

    # ---- 12. points + lines + planes -------------------------------------
    runs.update(plp_paths(fm, cam, cfg, N))
    phase_done("12")

    # ---- 13. host syncs of the batched linear algebra ----------------------
    sync_check()

    # ---- 14-16. the fisheye and equirectangular cameras ---------------------
    phase_done("13")
    runs["fisheye"] = fisheye_path(fm, cfg)
    phase_done("14")
    runs["equirect"] = equirect_path(fm)
    phase_done("15")
    rectify = rectify_fisheye()
    phase_done("16")

    # ---- 17. the I/O and viewer surfaces -----------------------------------
    io_modules()
    build_native()
    runs.update(io_paths(fm, cam, cfg, N, frames, poses))
    phase_done("17")

    # ---- 18. the landmark-sharded global BA ---------------------------------
    runs.update(mesh_paths(fm, cam, cfg, N))
    phase_done("18")

    # ---- 19. the public functions no path calls ------------------------------
    ops = public_ops(cam, frames[0][0])
    ops["knobs"] = knob_checks(cam, slam, frames)
    ops["dataset_frontends"] = dataset_frontends()
    ops["linalg"] = linalg_checks()
    ops["xla_cpu_routes"] = init_ba_checks()
    ops["chain_ba"] = chain_ba_checks()
    phase_done("19 (a-f)")
    ops["rgbd_chain_ba"] = rgbd_chain_ba_checks()
    phase_done("19 (g)")
    for k in kernels:
        site = k["name"].split("@")[1]
        k["launches_by_path"] = {p: r["site_launches"][site] for p, r in runs.items()}

    # ---- 20. result lines ------------------------------------------------
    paths = {p: {key: r[key] for key in ("frames", "tracked", "frames_per_s", "state",
                                         "keyframes", "landmarks", "relocalizations",
                                         "launches", "max_abs_err", "stage_median_ms",
                                         "max_keyframes", "max_landmarks", "gates")
                 + tuple(k for k in ("line_stage_median_ms", "profile", "syncs_per_frame",
                                     "plain_calls", "io", "cli", "mesh_solves",
                                     "kernel_timing") if k in r)}
             for p, r in runs.items()}
    print(json.dumps({"paths": paths}))
    print(json.dumps({"rectify_fisheye": rectify}))
    print(json.dumps({"public_ops": ops}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        _fail("a phase raised")
