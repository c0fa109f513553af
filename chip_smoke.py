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
   frames with ground truth. Checks tracking state, keyframe and landmark
   counts, ATE < 0.05 m and that every matcher call launched the kernel;
5. the kernel against its plain version on every input the main path
   gave it (all calls, exact), and at each call site its last call timed
   beside the plain version, a bf16 bit-plane matmul yardstick and the
   card's bound. Device times come
   from torch.profiler's kernel records, with the number of records
   summed; one call's time between CUDA events (which adds the launch's
   host time) is kept beside them. The inputs timed here are saved to
   build/fused_match_inputs.pt and timed in a fresh process (see
   time_in_child), which compare_fused_match.py reads too;
6. a torch.profiler pass over 8 frames of a fresh run, around its second
   keyframe chain: device operations per frame and per stage, device
   busy share, the heaviest kernels;
7. one JSON line with every kernel's numbers, the card line, and the
   result line ``{"ok": true, "device": {...}}`` last.

It needs a CUDA device and the repository around it; it never falls back
to the CPU and imports nothing of JAX.
"""

from __future__ import annotations

import json
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
}
REPLACES = "structure_plp_slam_tpu/ops/pallas_matching.py:42"
SOURCE = "structure_plp_slam_tpu_torch/csrc/fused_match.cu"
NUM_FRAMES = 40
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


def time_saved_inputs():
    """Phase 5's timings, run by time_in_child: for each call site's saved
    input, time_pair's numbers and the yardstick, printed as one JSON
    line."""
    from structure_plp_slam_tpu_torch.ops import fused_match as fm

    inputs = torch.load(INPUTS)
    device_ms(lambda: torch.ones(1024, device="cuda").add_(1), reps=2, warmup=1)
    out = {}
    for site in CALL_SITES:
        args = tuple(a.cuda() for a in inputs[site])
        out[site] = {**time_pair(fm, args), "yardstick_ms": bitplane_yardstick_ms(args)}
    print(json.dumps(out))


def time_in_child():
    """time_saved_inputs in a fresh process. Once the main path has run,
    the profiler sessions of this process come back short of kernel
    records (18-19 of 20 on the H100, or none), while a fresh process's
    come back whole."""
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.time_saved_inputs()"],
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


def profile_frames(make_system, frames, warm, count):
    """torch.profiler over ``count`` frames after ``warm`` untraced ones:
    device kernels per frame, device busy share of the wall time, and the
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slam = make_system(verbose_timing=False)
    slam.startup()
    for img, depth, ts in frames[:warm]:
        slam.feed_RGBD_frame(img, depth, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img, depth, ts in frames[warm:warm + count]:
            slam.feed_RGBD_frame(img, depth, ts)
        slam.shutdown()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels, copies and fills only: the device timeline also mirrors the
    # stage ranges, under the ranges' own names.
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith("stage.")]
    if not kernels:
        print("profile: the profiler recorded no device activity (not measured)")
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
        "frames": count,
        "wall_ms_per_frame": wall_ms / count,
        "device_busy_ms_per_frame": busy_us / 1e3 / count,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_ops_per_frame": len(kernels) / count,
        "top": [{"name": n[:80], "count": c, "ms": t / 1e3} for n, (c, t) in top],
        "stages": {k: {"calls": c, "device_ops_per_call": n / c, "device_ms_per_call": us / c / 1e3,
                       "host_ms_per_call": cpu / c / 1e3}
                   for k, (c, n, us, cpu) in stages.items()},
    }
    print(f"profile: {count} frames, wall {out['wall_ms_per_frame']:.3f} ms/frame, device busy "
          f"{out['device_busy_ms_per_frame']:.3f} ms/frame, idle share "
          f"{out['device_idle_share']:.4f}, {out['device_ops_per_frame']:.1f} device ops/frame")
    for name, s in out["stages"].items():
        print(f"profile stage {name}: {s['calls']} calls, {s['device_ops_per_call']:.1f} device "
              f"ops, {s['device_ms_per_call']:.3f} device ms, {s['host_ms_per_call']:.3f} host ms "
              f"per call (under the profiler)")
    for t in out["top"]:
        print(f"profile top: {t['ms']:.3f} ms in {t['count']} x {t['name']}")
    return out


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device (this script never runs on the CPU)")
    try:
        import structure_plp_slam_tpu_torch  # noqa: F401  (sets TF32 off)
        from structure_plp_slam_tpu_torch.ops import fused_match as fm
    except ImportError as e:
        _fail(f"the port package is not next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    def make_system(verbose_timing):
        return System(cfg, max_keyframes=256, max_landmarks=32768,
                      enable_loop_closing=False, verbose_timing=verbose_timing,
                      device="cuda")

    slam = make_system(verbose_timing=True)
    N = slam.frontend.pad_to
    rows_by_site = {"track_stage1": N, "track_stage2": min(8192, slam.max_landmarks),
                    "fuse": slam.max_landmarks}

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

    # ---- 4. main path at full width --------------------------------------
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(0), cam, NUM_FRAMES)

    # Keep every call's inputs, by call site (row count), for phase 5.
    recorded = {rows: [] for rows in rows_by_site.values()}

    def recording(fn):
        def call(*args):
            recorded[args[0].shape[0]].append(tuple(a.clone() for a in args))
            return fn(*args)
        return call

    tracker.fused_match = recording(fm.fused_match)
    mapper.fused_match = recording(fm.fused_match)
    slam.startup()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fm.reset_counts()
    tracked = 0
    stamps = []
    chain_feeds = []  # indices of the feeds during which a keyframe chain ran
    t0 = time.perf_counter()
    for i, (img, depth, ts) in enumerate(frames):
        next_kf = slam.next_kf
        if slam.feed_RGBD_frame(img, depth, ts) is not None:
            tracked += 1
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if slam.next_kf > next_kf and i > 0:
            chain_feeds.append(i)
    slam.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fm.fused_match.launches
    calls = fm.fused_match.calls
    by_rows = dict(fm.fused_match.launches_by_rows)
    tracker.fused_match = fm.fused_match
    mapper.fused_match = fm.fused_match

    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1)) for i, (R, t) in enumerate(poses)]
    ate = traj_io.ate_rmse(slam.frame_trajectory(), gt, align_scale=False)
    chains = slam.next_kf - 1
    steps = slam.num_track_steps
    state = slam.tracking_state
    print(f"main path: {NUM_FRAMES} frames, tracked {tracked}, state {state.value}, "
          f"keyframes {slam.num_keyframes} (chains {chains}), landmarks "
          f"{slam.num_landmarks}, ATE {ate:.6f} m")
    warm = 5
    print(f"frames/s: {NUM_FRAMES / wall:.3f} over all {NUM_FRAMES} frames "
          f"(stage-synced timer on); {(NUM_FRAMES - warm) / (stamps[-1] - stamps[warm - 1]):.3f} "
          f"after the first {warm}")
    print(f"peak torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name, s in slam.timer.summary().items():
        print(f"stage {name}: count {s['count']} mean {s['mean_ms']:.3f} ms "
              f"median {s['median_ms']:.3f} ms max {s['max_ms']:.3f} ms")
    print(f"keyframe chains ran during feeds {chain_feeds}")
    print(f"fused_match launches {launches} of {calls} calls (by rows {by_rows}); "
          f"expected 3 x {steps} track steps + {chains} chains = {3 * steps + chains}")
    if state is not TrackerState.TRACKING:
        raise AssertionError(f"ended in state {state.value}")
    if tracked < NUM_FRAMES - 1:
        raise AssertionError(f"tracked {tracked} of {NUM_FRAMES} frames")
    if slam.num_keyframes < 2 or slam.num_landmarks <= 200:
        raise AssertionError("too few keyframes or landmarks")
    if not ate < 0.05:
        raise AssertionError(f"ATE {ate} >= 0.05 m")
    if launches != 3 * steps + chains or calls != launches:
        raise AssertionError("the main path did not launch the kernel at every matcher call")
    launches_by_site = {"track_stage1": 2 * steps, "track_stage2": steps, "fuse": chains}
    if sorted(by_rows.items()) != sorted(
        (rows_by_site[s], launches_by_site[s]) for s in rows_by_site
    ):
        raise AssertionError(f"launches by row count {by_rows} != expected per call site")

    # ---- 5. kernel vs plain on the main path's own inputs -----------------
    # The last call at each site (and the dense fuse-sized input, for
    # compare_fused_match.py) saved on the host, and timed in a fresh process.
    timed = {site: recorded[rows][-1] for site, rows in rows_by_site.items()}
    timed[f"dense {rows_by_site['fuse']}x{N}"] = dense_args["fuse"]
    torch.save({k: tuple(a.cpu() for a in v) for k, v in timed.items()}, INPUTS)
    times = time_in_child()
    kernels = []
    for site, rows in rows_by_site.items():
        err = max(check_exact(fm, a, f"{site} call {k}") for k, a in enumerate(recorded[rows]))
        print(f"kernel == plain: {site}, all {len(recorded[rows])} main-path calls "
              f"(max_abs_err {err})")
        args = recorded[rows][-1]
        t = times[site]
        yard = t["yardstick_ms"]
        bound_ms, bound_by, active, pairs = bound(fm, args)
        tiles = measured_tiles(fm, args)
        print(f"{site}: {rows}x{N} ({active} active rows, {pairs} in-window pairs): device "
              f"kernel {t['kernel_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms ("
              f"{t['kernel_records']} / {t['plain_records']} records), bf16 bit-plane "
              f"matmul yardstick {yard:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); one call "
              f"{t['kernel_call_ms']:.4f} / {t['plain_call_ms']:.4f} ms; launches "
              f"{launches_by_site[site]}; tiles {tiles}")
        kernels.append({
            "name": f"fused_match@{site}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": launches_by_site[site],
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
            **dense[site],
        })

    # ---- 6. where the time goes -------------------------------------------
    # Eight frames around the second keyframe chain (the first with local
    # BA), which lands on the same feed in a fresh run of the same frames.
    start = chain_feeds[1] - 3 if len(chain_feeds) > 1 else 8
    profile_frames(make_system, frames, warm=start, count=8)

    # ---- 7. result lines -------------------------------------------------
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
