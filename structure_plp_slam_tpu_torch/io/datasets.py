"""Dataset parsers: TUM RGB-D, EuRoC MAV, KITTI odometry, image dirs.

Port of structure_plp_slam_tpu/io/datasets.py. Behavioral port of the
reference's example/util/ loaders
(tum_rgbd_util.h: rgb/depth txt association by nearest timestamp;
euroc_util.h: cam0/cam1 data.csv; kitti_util.h: image_0/1 + times.txt;
image_util for plain directories). Parsing is host-side numpy/Python —
pixels are decoded with OpenCV/PIL at feed time.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    img_path: str
    depth_path: Optional[str] = None
    right_img_path: Optional[str] = None
    mask_path: Optional[str] = None


def _read_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), rel))
    return out


def load_tum_rgbd(data_dir: str, max_diff: float = 0.02) -> List[FrameRecord]:
    """Associate rgb.txt and depth.txt by nearest timestamp
    (reference: example/util/tum_rgbd_util.h association logic)."""
    rgb = _read_tum_list(os.path.join(data_dir, "rgb.txt"))
    depth = _read_tum_list(os.path.join(data_dir, "depth.txt"))
    d_ts = np.array([t for t, _ in depth])
    out = []
    for ts, rel in rgb:
        i = int(np.argmin(np.abs(d_ts - ts)))
        if abs(d_ts[i] - ts) <= max_diff:
            out.append(
                FrameRecord(
                    timestamp=ts,
                    img_path=os.path.join(data_dir, rel),
                    depth_path=os.path.join(data_dir, depth[i][1]),
                )
            )
        else:
            out.append(FrameRecord(timestamp=ts, img_path=os.path.join(data_dir, rel)))
    return out


def load_euroc(data_dir: str, use_stereo: bool = True) -> List[FrameRecord]:
    """EuRoC mav0: cam0/data.csv (ns timestamps) + cam0/data/<ts>.png
    (reference: example/util/euroc_util.h)."""
    cam0_csv = os.path.join(data_dir, "mav0", "cam0", "data.csv")
    if not os.path.exists(cam0_csv):
        cam0_csv = os.path.join(data_dir, "cam0", "data.csv")
        base = data_dir
    else:
        base = os.path.join(data_dir, "mav0")
    out = []
    with open(cam0_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, name = line.split(",")[:2]
            ts = int(ts_ns) * 1e-9
            left = os.path.join(base, "cam0", "data", name.strip())
            right = os.path.join(base, "cam1", "data", name.strip())
            out.append(
                FrameRecord(
                    timestamp=ts,
                    img_path=left,
                    right_img_path=right if use_stereo and os.path.exists(right) else None,
                )
            )
    return out


def load_kitti(seq_dir: str, use_stereo: bool = True) -> List[FrameRecord]:
    """KITTI odometry: image_0/ + image_1/ + times.txt
    (reference: example/util/kitti_util.h)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(line.strip()) for line in f if line.strip()]
    out = []
    for i, ts in enumerate(times):
        left = os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        right = os.path.join(seq_dir, "image_1", f"{i:06d}.png")
        out.append(
            FrameRecord(
                timestamp=ts,
                img_path=left,
                right_img_path=right if use_stereo and os.path.exists(right) else None,
            )
        )
    return out


def attach_masks(frames: List[FrameRecord],
                 mask_dir: Optional[str]) -> List[FrameRecord]:
    """Pair PlaneRecNet instance masks to frames by image basename
    (reference: image_planeSeg_util.h / planeSeg_util.h mask folders).
    The single pairing convention for every loader."""
    if not mask_dir:
        return frames
    for rec in frames:
        stem = os.path.splitext(os.path.basename(rec.img_path))[0]
        cand = os.path.join(mask_dir, stem + ".png")
        if os.path.exists(cand):
            rec.mask_path = cand
    return frames


def load_image_dir(img_dir: str, fps: float = 30.0,
                   mask_dir: Optional[str] = None) -> List[FrameRecord]:
    """Plain image directory (reference: example/util/image_util.h); with
    ``mask_dir``, pairs PlaneRecNet instance masks by filename
    (image_planeSeg_util.h)."""
    names = sorted(
        n for n in os.listdir(img_dir)
        if n.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    out = [
        FrameRecord(timestamp=i / fps, img_path=os.path.join(img_dir, n))
        for i, n in enumerate(names)
    ]
    return attach_masks(out, mask_dir)


class PrefetchReader:
    """Background-thread frame decoder (double-ended prefetch queue).

    The reference decodes images on the feed thread; here the CLI reads
    ahead on a worker thread, so the decode overlaps tracking (cv2
    releases the GIL during imdecode).
    """

    def __init__(self, records, *, depth: bool = False, stereo: bool = False,
                 workers: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=workers * 4)
        self._records = records
        self._depth = depth
        self._stereo = stereo
        self._stop = False

        def producer():
            for rec in records:
                if self._stop:
                    break
                img = imread_gray(rec.img_path)
                # Raw depth units; the frontend applies the camera's
                # depthmap_factor exactly once (frontend.py rgbd path,
                # mirroring the reference where only data::frame scales
                # depth, frame.cc RGB-D ctor).
                d = (
                    imread_depth(rec.depth_path).astype(np.float32)
                    if depth and rec.depth_path
                    else None
                )
                r = (
                    imread_gray(rec.right_img_path)
                    if stereo and rec.right_img_path
                    else None
                )
                m = (
                    imread_depth(rec.mask_path).astype(np.int32)
                    if rec.mask_path
                    else None
                )
                self._q.put((rec, img, d, r, m))
            self._q.put(None)

        self._t = threading.Thread(target=producer, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop = True


def imread_gray(path: str) -> np.ndarray:
    """uint8 grayscale image loader (OpenCV with PIL fallback)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def imread_depth(path: str) -> np.ndarray:
    """uint16 depth map loader (TUM stores depth * 5000)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path))
