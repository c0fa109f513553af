"""YAML configuration, compatible with the reference's config files.

Port of structure_plp_slam_tpu/config.py. Reference:
src/PLPSLAM/config.{h,cc} — loads camera model/setup, ORB parameters,
depth threshold and depthmap factor from per-dataset YAML (e.g.
example/tum_rgbd/TUM_RGBD_mono_3.yaml). The same YAML files drive the port
unchanged: keys ``Camera.*``, ``Feature.*``, ``depth_threshold``,
``depthmap_factor``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.ops.orb import OrbParams


@dataclasses.dataclass(frozen=True)
class Config:
    camera: Camera
    orb: OrbParams
    raw: Dict[str, Any]

    @property
    def true_depth_threshold(self) -> float:
        return self.camera.true_depth_threshold

    @property
    def depthmap_factor(self) -> float:
        return self.camera.depthmap_factor


def load_config(path: Optional[str] = None, yaml_text: Optional[str] = None) -> Config:
    """Parse a reference-format YAML config into Camera + OrbParams."""
    import yaml

    if yaml_text is None:
        with open(path, "r") as f:
            yaml_text = f.read()
    # Reference YAMLs start with "%YAML:1.0" (OpenCV FileStorage dialect);
    # strip the directive for PyYAML.
    lines = [ln for ln in yaml_text.splitlines() if not ln.strip().startswith("%YAML")]
    d = yaml.safe_load("\n".join(lines)) or {}

    # The reference spells these "RGBD" / "monocular" / "perspective" etc.
    # (config.cc:55-85); accept any case.
    model = CameraModel(str(d.get("Camera.model", "perspective")).lower())
    setup = CameraSetup(str(d.get("Camera.setup", "monocular")).lower())
    camera = Camera(
        name=d.get("Camera.name", "unnamed"),
        setup=setup,
        model=model,
        cols=int(d.get("Camera.cols", 640)),
        rows=int(d.get("Camera.rows", 480)),
        fps=float(d.get("Camera.fps", 30.0)),
        fx=float(d.get("Camera.fx", 0.0)),
        fy=float(d.get("Camera.fy", 0.0)),
        cx=float(d.get("Camera.cx", 0.0)),
        cy=float(d.get("Camera.cy", 0.0)),
        k1=float(d.get("Camera.k1", 0.0)),
        k2=float(d.get("Camera.k2", 0.0)),
        p1=float(d.get("Camera.p1", 0.0)),
        p2=float(d.get("Camera.p2", 0.0)),
        k3=float(d.get("Camera.k3", 0.0)),
        k4=float(d.get("Camera.k4", 0.0)),
        focal_x_baseline=float(d.get("Camera.focal_x_baseline", 0.0)),
        depth_threshold=float(d.get("depth_threshold", 40.0)),
        depthmap_factor=float(d.get("depthmap_factor", 1.0)),
    )
    orb = OrbParams(
        max_num_keypts=int(d.get("Feature.max_num_keypoints", 2000)),
        scale_factor=float(d.get("Feature.scale_factor", 1.2)),
        num_levels=int(d.get("Feature.num_levels", 8)),
        ini_fast_thr=float(d.get("Feature.ini_fast_threshold", 20)),
        min_fast_thr=float(d.get("Feature.min_fast_threshold", 7)),
        mask_rects=tuple(
            tuple(float(v) for v in rect)
            for rect in (d.get("Feature.mask_rectangles", []) or [])
        ),
    )
    return Config(camera=camera, orb=orb, raw=d)
