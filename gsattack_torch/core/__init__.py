from .camera import Camera, CameraExtrinsics, make_camera, stack_cameras
from .scene import NUM_OBJECTS, GaussianScene, scene_from_points

__all__ = [
    "Camera",
    "CameraExtrinsics",
    "make_camera",
    "stack_cameras",
    "GaussianScene",
    "scene_from_points",
    "NUM_OBJECTS",
]
