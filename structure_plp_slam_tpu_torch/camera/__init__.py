from structure_plp_slam_tpu_torch.camera.base import (  # noqa: F401
    Camera,
    CameraModel,
    CameraSetup,
)
