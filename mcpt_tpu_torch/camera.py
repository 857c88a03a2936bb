"""Camera model (counterpart of `mcpt_tpu/camera.py:20-52`).

LookAt basis per the reference `src/Camera.hpp:17-24` (columns = left, up,
forward with left = up x forward — note the mirrored x that pairs with the
``1 - 2(i+u)/w`` screen mapping of `src/Renderer.cpp:47,67`). The
megakernel generates its primary rays itself (`kernels/megakernel_ref.py::
cam_ray`); the wavefront path takes them from `generate_rays_c`.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt


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


def generate_rays_c(camera: Camera, pixel_ids, key):
    """Primary rays for flat pixel ids (row-major, i = id % W, j = id // W)
    with `prng.uniform(key, (B, 4))` as the jitter and lens draws
    (`mcpt_tpu/camera.py:55-107`, Renderer.cpp:44-76): pinhole, or a thin
    lens with r = R·sqrt(u2), θ = 2π·u3 and the focal point at
    (x, y, 1)·focal_distance. Returns (o, d) as 3-tuples of (B,) float32
    tensors; directions are unit length."""
    w, h = camera.width, camera.height
    scale = float(np.float32(np.tan(np.deg2rad(camera.fov * 0.5))))
    aspect = float(np.float32(w / float(h)))
    om = camera.orientation().tolist()
    i = (pixel_ids % w).to(torch.float32)
    j = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    u = prng.uniform(key, (pixel_ids.shape[0], 4))
    # true division by tensors: CUDA torch multiplies by the reciprocal of
    # a Python scalar divisor, which rounds differently
    x = (1.0 - 2.0 * (i + u[:, 0]) / torch.full_like(i, w)) * aspect * scale
    y = (1.0 - 2.0 * (j + u[:, 1]) / torch.full_like(j, h)) * scale

    def rot(v):
        return tuple(om[k][0] * v[0] + om[k][1] * v[1] + om[k][2] * v[2] for k in range(3))

    if camera.use_dof:
        fd = float(np.float32(camera.focal_distance))
        r = float(np.float32(camera.aperture_radius)) * _sqrt(u[:, 2])
        theta = 2.0 * math.pi * u[:, 3]
        dx = r * torch.cos(theta)
        dy = r * torch.sin(theta)
        lens_w = rot((dx, dy, torch.zeros_like(dx)))
        origins = tuple(float(np.float32(camera.position[k])) + lens_w[k] for k in range(3))
        dirs = (x * fd - dx, y * fd - dy, torch.ones_like(x) * fd)
    else:
        dirs = (x, y, torch.ones_like(x))
        origins = tuple(torch.full_like(x, float(np.float32(camera.position[k]))) for k in range(3))
    inv = 1.0 / _sqrt(dirs[0] * dirs[0] + dirs[1] * dirs[1] + dirs[2] * dirs[2])
    return origins, rot(tuple(c * inv for c in dirs))
