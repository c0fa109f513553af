"""Map publisher: viewer-facing accessors over the MapState.

Port of structure_plp_slam_tpu/publish/map_publisher.py.
Reference: src/PLPSLAM/publish/map_publisher.cc:80-160 — thread-safe
getters for current pose, all/local landmarks, planes (with display
colors), lines. Here the MapState is immutable-functional, so accessors
simply snapshot the arrays; ``export_ply`` replaces the Pangolin/socket
viewers' 3D display with a standard point-cloud file any viewer opens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from structure_plp_slam_tpu_torch.utils.types import to_host


class MapPublisher:
    def __init__(self, system):
        self._sys = system
        self._current_pose: Optional[np.ndarray] = None

    # -- reference API parity ------------------------------------------
    def set_current_cam_pose(self, pose_cw):
        # Store the reference only — this runs on the hot tracking path
        # every frame; the host pull (and any concatenation) happens when
        # a viewer reads. Accepts either a [3,4] matrix or an (R, t) pair.
        self._current_pose = pose_cw

    def get_current_cam_pose(self) -> Optional[np.ndarray]:
        p = self._current_pose
        if p is None:
            return None
        if isinstance(p, tuple):
            R, t = (to_host(a) for a in p)
            return np.concatenate([R, t[:, None]], axis=1)
        return to_host(p)

    def snapshot(self) -> "MapSnapshot":
        """One consistent capture of the map for viewer threads.

        The system swaps its MapState reference atomically (a NamedTuple of
        tensors that the System replaces, never writes into), so reading
        the reference ONCE yields a self-consistent map even while
        tracking mutates the system — every derived array below comes from
        that single read. Viewer code must use this instead of calling the
        getters repeatedly (each getter re-reads the live state and can
        see different versions).

        It reads the System's published map (``_state``), not its
        ``state`` property: that one applies the pending frame decisions,
        which only the thread that feeds frames may do. So a viewer polling
        mid-run sees the map up to the last consumed frame (``track_lag``
        frames behind the feed).
        """
        sysm = self._sys
        return MapSnapshot(
            sysm._state, self._current_pose,
            camera=sysm.camera,
            dense_frames=dict(getattr(sysm, "_dense_frames", {})),
            dense_stride=getattr(sysm, "dense_cloud_stride", 8),
        )

    def get_landmarks(self) -> np.ndarray:
        return self.snapshot().get_landmarks()

    def get_landmark_colors(self) -> np.ndarray:
        """Per-landmark RGB: plane-owned landmarks get the plane's color
        (reference: planes carry a random display color)."""
        return self.snapshot().get_landmark_colors()

    def get_keyframe_poses(self) -> np.ndarray:
        return self.snapshot().get_keyframe_poses()

    def get_lines(self) -> np.ndarray:
        """[M, 6] world endpoint pairs of valid 3D lines."""
        return self.snapshot().get_lines()

    def get_planes(self) -> np.ndarray:
        """[P, 4] plane coefficients."""
        return self.snapshot().get_planes()

    def get_dense_cloud(self, max_points_per_kf: int = 3000):
        """(points [N,3], gray [N] u8) backprojected from the stored
        per-keyframe strided RGB-D images under CURRENT keyframe poses
        (reference: the viewer's dense RGB-D cloud display,
        pangolin_viewer/viewer.h:132-133). Empty unless the System was
        built with store_dense_cloud=True."""
        return self.snapshot().get_dense_cloud(max_points_per_kf)

    # -- export --------------------------------------------------------
    def export_html(self, path: str, max_points: int = 20000):
        """Interactive single-file HTML map viewer (publish/html_viewer.py —
        the static equivalent of the reference's web viewer)."""
        from structure_plp_slam_tpu_torch.publish.html_viewer import export_html

        export_html(path, self, max_points=max_points)

    def export_ply(self, path: str, with_trajectory: bool = True):
        """Write landmarks (+ keyframe centers) as an ASCII PLY cloud."""
        snap = self.snapshot()
        pts = snap.get_landmarks()
        cols = snap.get_landmark_colors()
        rows = [pts]
        colrows = [cols]
        if with_trajectory:
            kf = snap.get_keyframe_poses()
            centers = np.stack([-P[:, :3].T @ P[:, 3] for P in kf]) if len(kf) else np.zeros((0, 3))
            rows.append(centers)
            colrows.append(np.tile([255, 0, 0], (len(centers), 1)))
        allp = np.concatenate(rows)
        allc = np.concatenate(colrows).astype(int)
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(allp)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            for p, c in zip(allp, allc):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


class MapSnapshot:
    """Read-only view over ONE MapState capture (see
    :meth:`MapPublisher.snapshot`). Same getter API as the publisher."""

    def __init__(self, state, current_pose, camera=None, dense_frames=None,
                 dense_stride: int = 8):
        self._state = state
        self._current_pose = current_pose
        self._camera = camera
        self._dense_frames = dense_frames or {}
        self._dense_stride = dense_stride

    def get_current_cam_pose(self) -> Optional[np.ndarray]:
        p = self._current_pose
        if p is None:
            return None
        if isinstance(p, tuple):
            R, t = (to_host(a) for a in p)
            return np.concatenate([R, t[:, None]], axis=1)
        return to_host(p)

    def get_landmarks(self) -> np.ndarray:
        st = self._state
        valid = to_host(st.lm_valid)
        return to_host(st.lm_pos)[valid]

    def get_landmark_colors(self) -> np.ndarray:
        st = self._state
        valid = to_host(st.lm_valid)
        plane = to_host(st.lm_plane)[valid]
        rng = np.random.default_rng(0)
        palette = rng.integers(64, 255, size=(int(st.pl_coef.shape[0]), 3))
        colors = np.full((int(valid.sum()), 3), 180, np.uint8)
        owned = plane >= 0
        colors[owned] = palette[plane[owned] % len(palette)]
        return colors

    def get_keyframe_poses(self) -> np.ndarray:
        st = self._state
        valid = to_host(st.kf_valid)
        return to_host(st.kf_pose)[valid]

    def get_lines(self) -> np.ndarray:
        st = self._state
        valid = to_host(st.ln_valid)
        return to_host(st.ln_endpoints)[valid]

    def get_planes(self) -> np.ndarray:
        st = self._state
        valid = to_host(st.pl_valid)
        return to_host(st.pl_coef)[valid]

    def get_dense_cloud(self, max_points_per_kf: int = 3000):
        """See MapPublisher.get_dense_cloud."""
        cam = self._camera
        if cam is None or not self._dense_frames:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.uint8)
        st = self._state
        kf_pose = to_host(st.kf_pose)
        kf_valid = to_host(st.kf_valid)
        s = self._dense_stride
        pts_all, gray_all = [], []
        for slot, (gray, depth) in self._dense_frames.items():
            if slot >= len(kf_valid) or not kf_valid[slot]:
                continue
            gray, depth = to_host(gray), to_host(depth)
            h, w = depth.shape
            vs, us = np.mgrid[0:h, 0:w]
            u0 = us * s + s // 2
            v0 = vs * s + s // 2
            ok = depth > 1e-6
            if not ok.any():
                continue
            z = depth[ok]
            x = (u0[ok] - cam.cx) / cam.fx * z
            y = (v0[ok] - cam.cy) / cam.fy * z
            pc = np.stack([x, y, z], -1)
            if len(pc) > max_points_per_kf:
                sel = np.random.default_rng(slot).choice(
                    len(pc), max_points_per_kf, replace=False)
                pc = pc[sel]
                g = gray[ok][sel]
            else:
                g = gray[ok]
            P = kf_pose[slot]
            R, t = P[:, :3], P[:, 3]
            pw = (pc - t) @ R  # R^T (pc - t)
            pts_all.append(pw.astype(np.float32))
            gray_all.append(g.astype(np.uint8))
        if not pts_all:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.uint8)
        return np.concatenate(pts_all), np.concatenate(gray_all)
