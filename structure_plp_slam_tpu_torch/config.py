"""System configuration.

Port of the ``Config`` dataclass of structure_plp_slam_tpu/config.py.
Loading the reference's YAML files (``load_config``) waits for the CLI
slice (ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from structure_plp_slam_tpu_torch.camera import Camera
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
