"""Camera model (counterpart of `mcpt_tpu/camera.py:20-52`).

LookAt basis per the reference `src/Camera.hpp:17-24` (columns = left, up,
forward with left = up x forward — note the mirrored x that pairs with the
``1 - 2(i+u)/w`` screen mapping of `src/Renderer.cpp:47,67`). The
megakernel generates its primary rays itself (`kernels/megakernel_ref.py::
cam_ray`); the wavefront path takes them from `kernels/wavefront.py::
camera_rays` (the counterpart of `mcpt_tpu/camera.py:55-107`
`generate_rays_c`), whose kernel is `camera_rays` of `csrc/wavefront.cu`.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Camera:
    """Immutable; update with ``dataclasses.replace``. Defaults per
    Camera.hpp:10-16."""

    width: int = 1280
    height: int = 960
    fov: float = 40.0
    position: tuple = (0.0, 0.0, 0.0)
    target: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, 1.0, 0.0)
    use_dof: bool = False
    focal_distance: float = 100.0
    aperture_radius: float = 5.0

    def __post_init__(self):
        object.__setattr__(self, "position", tuple(float(x) for x in self.position))
        object.__setattr__(self, "target", tuple(float(x) for x in self.target))
        object.__setattr__(self, "up", tuple(float(x) for x in self.up))

    def orientation(self) -> np.ndarray:
        """3x3 with columns (left, up', forward); Camera.hpp:17-24."""
        pos = np.asarray(self.position, dtype=np.float64)
        target = np.asarray(self.target, dtype=np.float64)
        up = np.asarray(self.up, dtype=np.float64)
        forward = target - pos
        forward = forward / np.linalg.norm(forward)
        left = np.cross(up, forward)
        left = left / np.linalg.norm(left)
        new_up = np.cross(forward, left)
        new_up = new_up / np.linalg.norm(new_up)
        return np.stack([left, new_up, forward], axis=1).astype(np.float32)

