"""Unified CLI driver: the reference's example binaries as subcommands.

Port of structure_plp_slam_tpu/run.py, with the same subcommands and
flags, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU). Reference: example/run_{tum_rgbd,euroc,kitti}_slam[_with_line],
run_image_slam, run_video_slam, run_image_localization, ...
(example/*.cc, popl CLI; pattern at run_slam_planeSeg.cc:55-200):

    python -m structure_plp_slam_tpu_torch.run tum_rgbd -c cfg.yaml -d <dir> [...]
    python -m structure_plp_slam_tpu_torch.run euroc    -c cfg.yaml -d <dir>
    python -m structure_plp_slam_tpu_torch.run kitti    -c cfg.yaml -d <seq_dir>
    python -m structure_plp_slam_tpu_torch.run images   -c cfg.yaml -d <img_dir>
    python -m structure_plp_slam_tpu_torch.run video    -c cfg.yaml --video <file>
    python -m structure_plp_slam_tpu_torch.run camera   -c cfg.yaml [--cam-index 0]

Common flags mirror the reference drivers: --frame-skip, --eval-log (dump
track_times.txt), --map-db-out / --map-db-in (save a map snapshot;
localize against one), trajectory outputs. The last line printed is one
JSON object with the run's counts and per-frame feed times.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _common(sub, need_dir: bool = True):
    sub.add_argument("-c", "--config", required=True, help="YAML config")
    sub.add_argument("-d", "--data-dir", required=need_dir)
    sub.add_argument("--frame-skip", type=int, default=1)
    sub.add_argument("--max-frames", type=int, default=0)
    sub.add_argument("--eval-log", action="store_true")
    sub.add_argument("--frame-traj", default="frame_trajectory.txt")
    sub.add_argument("--keyframe-traj", default="keyframe_trajectory.txt")
    sub.add_argument("--traj-format", choices=["tum", "kitti"], default="tum")
    sub.add_argument("--max-keyframes", type=int, default=256)
    sub.add_argument("--max-landmarks", type=int, default=32768)
    sub.add_argument("--dense-cloud", action="store_true",
                     help="store strided per-keyframe RGB-D images and show "
                          "the dense cloud in viewers/exports (reference: "
                          "pangolin viewer dense display)")
    sub.add_argument("--with-lines", action="store_true",
                     help="enable line tracking (reference: *_with_line drivers)")
    sub.add_argument("--mask-dir", default=None,
                     help="PlaneRecNet instance-mask directory (planeSeg drivers)")
    sub.add_argument("--map-db-out", default=None,
                     help="save map snapshot after the run")
    sub.add_argument("--map-db-in", default=None,
                     help="load map snapshot before the run (localization "
                          "mode: mapping disabled; reference run_image_localization)")
    sub.add_argument("--viewer", nargs="?", type=int, const=0, default=None,
                     metavar="PORT",
                     help="serve the live web map viewer (reference: socket "
                          "publisher + node viewer); PORT optional, 0=ephemeral")
    sub.add_argument("--export-map-html", default=None, metavar="PATH",
                     help="write the standalone interactive HTML map viewer "
                          "after the run")
    sub.add_argument("--log-level", default=None,
                     choices=["debug", "info", "warning", "error"],
                     help="framework log level (reference: spdlog level in "
                          "the example drivers; default from "
                          "PLPSLAM_LOG_LEVEL env, else warning)")
    sub.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda; 'cpu' for the CPU)")


def _make_system(args, cfg):
    from structure_plp_slam_tpu_torch.system import System

    slam = System(
        cfg, max_keyframes=args.max_keyframes, max_landmarks=args.max_landmarks,
        with_lines=args.with_lines, store_dense_cloud=args.dense_cloud, device=args.device,
    )
    if args.map_db_in:
        slam.load_map_database(args.map_db_in)
        slam.disable_mapping_module()
        slam.startup(need_initialize=False)
    else:
        slam.startup()
    if args.viewer is not None:
        print(f"live viewer: http://localhost:{slam.start_live_viewer(args.viewer)}")
    return slam


def _finish(args, slam, track_times):
    """Shut down, write the outputs the flags ask for; returns the
    median and mean feed time (s)."""
    slam.shutdown()
    if args.map_db_out:
        slam.save_map_database(args.map_db_out)
    if args.export_map_html:
        slam.get_map_publisher().export_html(args.export_map_html)
    slam.save_frame_trajectory(args.frame_traj, fmt=args.traj_format)
    slam.save_keyframe_trajectory(args.keyframe_traj, fmt=args.traj_format)
    if args.eval_log:
        with open("track_times.txt", "w") as f:
            for t in track_times:
                f.write(f"{t:.6f}\n")
    med = float(np.median(track_times)) if track_times else 0.0
    mean = float(np.mean(track_times)) if track_times else 0.0
    return med, mean


def main(argv=None):
    ap = argparse.ArgumentParser(prog="structure_plp_slam_tpu_torch.run")
    sp = ap.add_subparsers(dest="cmd", required=True)
    for name in ("tum_rgbd", "euroc", "kitti", "images"):
        _common(sp.add_parser(name))
    # Video-file / live-camera monocular drivers (reference:
    # example/run_video_slam.cc, run_camera_slam.cc).
    video = sp.add_parser("video")
    _common(video, need_dir=False)
    video.add_argument("--video", required=True, help="video file path")
    camera = sp.add_parser("camera")
    _common(camera, need_dir=False)
    camera.add_argument("--cam-index", type=int, default=0)
    args = ap.parse_args(argv)

    from structure_plp_slam_tpu_torch.camera import CameraSetup
    from structure_plp_slam_tpu_torch.config import load_config
    from structure_plp_slam_tpu_torch.io import datasets
    from structure_plp_slam_tpu_torch.utils.logging import configure as configure_logging

    configure_logging(args.log_level)
    cfg = load_config(args.config)
    if args.cmd in ("video", "camera"):
        return _run_stream(args, cfg)
    if args.cmd == "tum_rgbd":
        frames = datasets.load_tum_rgbd(args.data_dir)
    elif args.cmd == "euroc":
        frames = datasets.load_euroc(args.data_dir)
    elif args.cmd == "kitti":
        frames = datasets.load_kitti(args.data_dir)
    else:
        frames = datasets.load_image_dir(args.data_dir, fps=cfg.camera.fps)
    frames = datasets.attach_masks(frames, args.mask_dir)

    frames = frames[:: args.frame_skip]
    if args.max_frames:
        frames = frames[: args.max_frames]

    slam = _make_system(args, cfg)
    # Stereo rectification (reference: util/stereo_rectifier driven by the
    # StereoRectifier YAML node — EuRoC raw pairs are distorted and
    # non-coplanar; the row-based stereo matcher needs rectified input).
    rectifier = None
    if cfg.camera.setup is CameraSetup.STEREO:
        from structure_plp_slam_tpu_torch.ops.rectify import StereoRectifier

        if StereoRectifier.available(cfg.raw):
            rectifier = StereoRectifier(cfg.camera, cfg.raw, device=slam.device)
    track_times = []
    reader = datasets.PrefetchReader(
        frames,
        depth=cfg.camera.setup is CameraSetup.RGBD,
        stereo=any(r.right_img_path for r in frames[:1]),
    )
    for rec, img, depth, right, mask in reader:
        t0 = time.perf_counter()
        if cfg.camera.setup is CameraSetup.RGBD and depth is not None:
            slam.feed_RGBD_frame(img, depth, rec.timestamp, seg_mask=mask)
        elif right is not None:
            if rectifier is not None:
                img, right = rectifier(img, right)
            slam.feed_stereo_frame(img, right, rec.timestamp, seg_mask=mask)
        else:
            slam.feed_monocular_frame(img, rec.timestamp, seg_mask=mask)
        track_times.append(time.perf_counter() - t0)
    med, mean = _finish(args, slam, track_times)
    m = slam.metrics()
    print(json.dumps({
        "frames": len(frames),
        "keyframes": slam.num_keyframes,
        "landmarks": slam.num_landmarks,
        "lines": m["lines"],
        "planes": m["planes"],
        "loops_closed": m["loops_closed"],
        "median_track_time_s": round(med, 4),
        "mean_track_time_s": round(mean, 4),
    }))


def _run_stream(args, cfg):
    """Video-file / live-camera monocular loop (reference:
    example/run_video_slam.cc:60-150, run_camera_slam.cc)."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise SystemExit("video/camera drivers require OpenCV (cv2)") from e

    cap = cv2.VideoCapture(args.video if args.cmd == "video" else args.cam_index)
    if not cap.isOpened():
        raise SystemExit("could not open video source")
    fps = cap.get(cv2.CAP_PROP_FPS) or cfg.camera.fps or 30.0

    slam = _make_system(args, cfg)
    track_times = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % args.frame_skip == 0:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
            ts = idx / fps if args.cmd == "video" else time.time()
            t0 = time.perf_counter()
            slam.feed_monocular_frame(gray, ts)
            track_times.append(time.perf_counter() - t0)
        idx += 1
        if args.max_frames and idx >= args.max_frames:
            break
    cap.release()
    med, _ = _finish(args, slam, track_times)
    print(json.dumps({
        "frames": idx,
        "keyframes": slam.num_keyframes,
        "landmarks": slam.num_landmarks,
        "median_track_time_s": round(med, 4),
    }))


if __name__ == "__main__":
    main()
