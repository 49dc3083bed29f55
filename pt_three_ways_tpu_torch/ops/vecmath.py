"""Batched 3-vector math — component-major ("planar") layout.

Vectors are tensors of shape [3, *batch]: axis 0 is x/y/z, batch axes
trail, as in the JAX package, so a [3, N] vector reads as three coalesced
rows on the GPU and the tests compare like with like.

Reference parity notes (pt-three-ways ``src/math``):
  - ``reflect``      == Norm3::reflect (src/math/Norm3.impl.h:42-45)
  - ``reflectance``  == Norm3::reflectance (src/math/Norm3.cpp:7-24), including
    the reference's quirk that rPerpendicular and rParallel use the *same*
    formula — replicated so images match.
  - ``onb_from_z``   == OrthoNormalBasis::fromZ (src/math/OrthoNormalBasis.cpp:41-52)
  - ``cone_sample``  == coneSample (src/math/Samples.cpp:6-20)
  - ``hemisphere_sample`` == hemisphereSample (src/math/Samples.cpp:22-31)

Rounding: on the CPU these functions follow the float32 rounding of the
JAX package's compiled CPU code (ops/xla_cpu.py) — fused multiply-adds
where XLA contracts them, XLA's ``rsqrt``, float64-evaluated ``sqrt`` and
trigonometry — so CPU renders track the JAX package draw for draw. On a
CUDA device they are plain float32 operations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import tracing
from .xla_cpu import fma, rsqrt, via64

# Geometric epsilon (the reference's 1e-9 f64 value, scaled for f32).
EPSILON = 1e-4


def dotc(a, b) -> torch.Tensor:
    """Dot product over the leading xyz axis, contracted as XLA does:
    fma(a2, b2, fma(a0, b0, a1 * b1))."""
    return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return via64(torch.sqrt, x)


def fsin(x: torch.Tensor) -> torch.Tensor:
    return via64(torch.sin, x)


def fcos(x: torch.Tensor) -> torch.Tensor:
    return via64(torch.cos, x)


def facos(x: torch.Tensor) -> torch.Tensor:
    return via64(torch.arccos, x)


def vec3(x, y, z) -> torch.Tensor:
    """Stack three scalar fields into a [3, *batch] vector."""
    return torch.stack([x, y, z], dim=0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return vec3(
        fma(a[1], b[2], -(a[2] * b[1])),
        fma(a[2], b[0], -(a[0] * b[2])),
        fma(a[0], b[1], -(a[1] * b[0])),
    )


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0."""
    pos = x > 0
    return torch.where(pos, fsqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def normalise(a: torch.Tensor) -> torch.Tensor:
    """Unit vector; zero input gives zero."""
    n2 = dotc(a, a)
    pos = n2 > 0
    inv = torch.where(
        pos, rsqrt(torch.where(pos, n2, torch.ones_like(n2))), torch.zeros_like(n2)
    )
    return a * inv


def reflect(incoming: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror ``incoming`` about ``normal`` (both unit). Norm3.impl.h:42-45."""
    return fma(-normal, 2.0 * dotc(incoming, normal), incoming)


def reflectance(normal, incoming, ior_from, ior_to) -> torch.Tensor:
    """Fresnel reflectance with total-internal-reflection clamp
    (src/math/Norm3.cpp:7-24), with the reference's rPerp == rParallel
    quirk and the 0/0 guard at the exact-grazing TIR boundary."""
    ior_ratio = ior_from / ior_to
    cos_i = -dotc(incoming, normal)
    sin_t_sq = ior_ratio * ior_ratio * fma(-cos_i, cos_i, 1.0)
    cos_t = safe_sqrt(1.0 - sin_t_sq)
    den = ior_from * cos_i + ior_to * cos_t
    ok = den > 0.0
    r_perp = torch.where(
        ok,
        (ior_from * cos_i - ior_to * cos_t) / torch.where(ok, den, torch.ones_like(den)),
        torch.ones_like(den),
    )
    fresnel = r_perp * r_perp
    return torch.where(sin_t_sq > 1.0, torch.ones_like(fresnel), fresnel)


class Onb(NamedTuple):
    """Orthonormal basis, each axis [3, *batch]."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def transform(self, v) -> torch.Tensor:
        """x*v_x + y*v_y + z*v_z (OrthoNormalBasis.h:19-21)."""
        return fma(self.z, v[2], fma(self.x, v[0], self.y * v[1]))


_COINCIDENT = 0.9999


def onb_from_z(z: torch.Tensor) -> Onb:
    """Basis around unit z with the coincident-axis guard at 0.9999."""
    use_y = torch.abs(z[0]) > _COINCIDENT
    shape = (3,) + (1,) * (z.dim() - 1)
    with tracing.span("pt3.sync.onb"):  # copies from host memory wait for the card
        piv_y = torch.tensor([0.0, 1.0, 0.0], dtype=z.dtype, device=z.device).reshape(shape)
        piv_x = torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device).reshape(shape)
    pivot = torch.where(use_y, piv_y, piv_x)
    xx = normalise(cross(pivot, z))
    yy = normalise(cross(z, xx))
    return Onb(xx, yy, z)


def cone_sample(direction, cone_theta, u, v) -> torch.Tensor:
    """Glossy cone sample around ``direction`` (src/math/Samples.cpp:6-20);
    cone angles below EPSILON return ``direction`` (mirror early-out)."""
    theta = cone_theta * (1.0 - 2.0 * facos(torch.clamp(u, 0.0, 1.0)) / math.pi)
    radius = fsin(theta)
    z_scale = fcos(theta)
    random_theta = v * (2.0 * math.pi)
    basis = onb_from_z(direction)
    sampled = normalise(
        basis.transform(
            (fcos(random_theta) * radius, fsin(random_theta) * radius, z_scale)
        )
    )
    mirror = cone_theta < EPSILON
    return torch.where(mirror, direction, sampled)


def hemisphere_sample(basis: Onb, u, v) -> torch.Tensor:
    """Cosine-weighted hemisphere sample (src/math/Samples.cpp:22-31)."""
    theta = (2.0 * math.pi) * u
    radius = fsqrt(v)
    return normalise(
        basis.transform(
            (fcos(theta) * radius, fsin(theta) * radius, safe_sqrt(1.0 - v))
        )
    )
