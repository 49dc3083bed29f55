"""Pinhole + thin-lens camera, batched over rays.

Faithful to the reference Camera (src/math/Camera.h:10-62):
  * basis = OrthoNormalBasis::fromZY(normalise(lookAt - eye), up)
  * plane distance = 1 / tan(verticalFov * pi / 360)
  * unit mapping (2x-1, 2y-1) with negated x/y axis contributions
  * thin-lens depth of field samples the aperture disc uniformly in RADIUS
    (not area) — a reference quirk replicated for image parity.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import tracing
from .vecmath import fcos, fma, fsin, fsqrt, normalise


class Camera(NamedTuple):
    centre: torch.Tensor  # [3]
    axis_x: torch.Tensor  # [3]
    axis_y: torch.Tensor  # [3]
    axis_z: torch.Tensor  # [3]
    aspect: torch.Tensor  # []
    plane_dist: torch.Tensor  # []
    recip_w: torch.Tensor  # []
    recip_h: torch.Tensor  # []
    aperture: torch.Tensor  # []
    focal_dist: torch.Tensor  # []

    def to(self, device) -> "Camera":
        return Camera(*(f.to(device) for f in self))


def make_camera(eye, look_at, up, width: int, height: int,
                vertical_fov_degrees: float, dtype=torch.float32,
                device="cpu") -> Camera:
    eye = np.asarray(eye, np.float64).reshape(3)
    look_at = np.asarray(look_at, np.float64).reshape(3)
    up = np.asarray(up, np.float64).reshape(3)
    up = up / np.linalg.norm(up)
    z = look_at - eye
    z = z / np.linalg.norm(z)
    # fromZY (src/math/OrthoNormalBasis.cpp:34-39), computed on host in f64.
    xx = np.cross(up, z)
    xx = xx / np.linalg.norm(xx)
    yy = np.cross(z, xx)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
    return Camera(
        centre=t(eye),
        axis_x=t(xx),
        axis_y=t(yy),
        axis_z=t(z),
        aspect=t(width / height),
        plane_dist=t(1.0 / math.tan(vertical_fov_degrees * math.pi / 360.0)),
        recip_w=t(1.0 / width),
        recip_h=t(1.0 / height),
        aperture=t(0.0),
        focal_dist=t(0.0),
    )


def set_focus(camera: Camera, focal_point, aperture_radius: float) -> Camera:
    """Camera::setFocus (src/math/Camera.h:48-51); float32 like the JAX
    package (the distance is reduced in the camera's dtype)."""
    fp = torch.as_tensor(np.asarray(focal_point, np.float64),
                         dtype=camera.centre.dtype, device=camera.centre.device)
    diff = fp - camera.centre
    focal_dist = fsqrt(torch.sum(diff * diff))
    return camera._replace(
        aperture=torch.as_tensor(aperture_radius, dtype=camera.centre.dtype,
                                 device=camera.centre.device),
        focal_dist=focal_dist,
    )


def generate_rays(camera: Camera, px: torch.Tensor, py: torch.Tensor,
                  uniforms: torch.Tensor):
    """Camera::randomRay for a batch of pixels (src/math/Camera.h:55-61).

    px/py: [R] int pixel coordinates; uniforms: [4, R] in [0, 1) (jitter x,
    jitter y, lens angle, lens radius). Returns (origins [3, R], directions
    [3, R]).
    """
    dtype = camera.centre.dtype
    # ux = 2 * ((px + jitter) / W) - 1, in the rounding of the JAX package's
    # compiled CPU code, where the camera is a constant: 2/W is folded and
    # the product fused into the subtraction (ops/xla_cpu.py)
    ux = fma(px.to(dtype) + uniforms[0], 2.0 * camera.recip_w, -1.0)
    uy = fma(py.to(dtype) + uniforms[1], 2.0 * camera.recip_h, -1.0)
    direction = normalise(
        fma(camera.axis_x[:, None], -ux * camera.aspect,
            camera.axis_y[:, None] * (-uy))
        + camera.axis_z[:, None] * camera.plane_dist
    )
    pinhole_org = camera.centre[:, None].expand_as(direction)

    focal_point = fma(direction, camera.focal_dist, camera.centre[:, None])
    angle = uniforms[2] * (2.0 * math.pi)
    radius = uniforms[3] * camera.aperture
    lens_org = fma(
        camera.axis_y[:, None], fsin(angle) * radius,
        fma(camera.axis_x[:, None], fcos(angle) * radius, camera.centre[:, None]),
    )
    lens_dir = normalise(focal_point - lens_org)

    with tracing.span("pt3.sync.aperture"):
        use_lens = bool(camera.aperture > 0.0)
    if use_lens:
        return lens_org, lens_dir
    return pinhole_org.contiguous(), direction
