"""Frame publisher: latest tracked-frame snapshot for viewers.

Port of structure_plp_slam_tpu/publish/frame_publisher.py.
Reference: src/PLPSLAM/publish/frame_publisher.cc — tracking pushes the
current image/keypoints/state under a mutex; viewers poll and draw.
Here the System updates the snapshot after each frame; ``draw()`` renders
the annotated frame (keypoints colored by association, line segments,
tracking state banner).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from structure_plp_slam_tpu_torch.utils.types import to_host


@dataclasses.dataclass
class FrameSnapshot:
    image: Optional[np.ndarray] = None          # grayscale [H, W]
    kp_xy: Optional[np.ndarray] = None          # [N, 2]
    kp_valid: Optional[np.ndarray] = None       # [N]
    kp_has_landmark: Optional[np.ndarray] = None  # [N]
    kp_plane: Optional[np.ndarray] = None       # [N] owning plane (-1)
    segments: Optional[np.ndarray] = None       # [M, 4]
    seg_valid: Optional[np.ndarray] = None      # [M]
    state: str = "NotInitialized"
    num_tracked: int = 0
    timestamp: float = 0.0


class FramePublisher:
    def __init__(self):
        self._snap = FrameSnapshot()
        self._raw = None

    def update(self, *, image, kp_xy, kp_valid, kp_has_landmark,
               kp_plane=None, segments=None, seg_valid=None,
               state="Tracking", num_tracked=0, timestamp=0.0):
        """Store the latest frame's references. Device tensors are NOT
        pulled to the host here — update() runs on the hot tracking path
        every frame; materialization happens in snapshot() when a viewer
        actually polls (the reference's copy-under-mutex becomes
        copy-on-read)."""
        self._raw = dict(
            image=image, kp_xy=kp_xy, kp_valid=kp_valid,
            kp_has_landmark=kp_has_landmark, kp_plane=kp_plane,
            segments=segments, seg_valid=seg_valid, state=state,
            num_tracked=num_tracked, timestamp=timestamp,
        )

    def snapshot(self) -> FrameSnapshot:
        raw = self._raw
        if raw is not None:
            self._snap = FrameSnapshot(
                image=to_host(raw["image"]),
                kp_xy=to_host(raw["kp_xy"]),
                kp_valid=to_host(raw["kp_valid"]),
                kp_has_landmark=to_host(raw["kp_has_landmark"]),
                kp_plane=(None if raw["kp_plane"] is None
                          else to_host(raw["kp_plane"])),
                segments=(None if raw["segments"] is None
                          else to_host(raw["segments"])),
                seg_valid=(None if raw["seg_valid"] is None
                           else to_host(raw["seg_valid"])),
                state=raw["state"],
                num_tracked=int(raw["num_tracked"]),
                timestamp=float(raw["timestamp"]),
            )
            self._raw = None
        return self._snap

    def draw_frame(self) -> Optional[np.ndarray]:
        """RGB uint8 visualization (reference: frame_publisher draw_tracked
        points; plane-owned points get distinct colors)."""
        s = self.snapshot()
        if s.image is None:
            return None
        img = np.clip(s.image, 0, 255).astype(np.uint8)
        rgb = np.stack([img] * 3, axis=-1)
        H, W = img.shape

        def disc(x, y, color):
            xi, yi = int(round(x)), int(round(y))
            if 1 <= xi < W - 1 and 1 <= yi < H - 1:
                rgb[yi - 1 : yi + 2, xi - 1 : xi + 2] = color

        palette = np.array(
            [[255, 99, 71], [135, 206, 250], [255, 215, 0], [144, 238, 144],
             [221, 160, 221], [255, 165, 0], [176, 224, 230], [240, 128, 128]],
            np.uint8,
        )
        for i in range(len(s.kp_xy)):
            if not s.kp_valid[i]:
                continue
            if s.kp_has_landmark[i]:
                if s.kp_plane is not None and s.kp_plane[i] >= 0:
                    c = palette[int(s.kp_plane[i]) % len(palette)]
                else:
                    c = np.array([0, 255, 0], np.uint8)
                disc(s.kp_xy[i, 0], s.kp_xy[i, 1], c)
        if s.segments is not None:
            for j in range(len(s.segments)):
                if not s.seg_valid[j]:
                    continue
                x1, y1, x2, y2 = s.segments[j]
                n = int(max(abs(x2 - x1), abs(y2 - y1))) + 1
                xs = np.clip(np.linspace(x1, x2, n).astype(int), 0, W - 1)
                ys = np.clip(np.linspace(y1, y2, n).astype(int), 0, H - 1)
                rgb[ys, xs] = [255, 0, 255]
        return rgb
