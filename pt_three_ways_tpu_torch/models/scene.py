"""Scene representation: host-side builder -> device-side SoA tensors.

The same layout as the JAX package's scene (the reference's DoD scene,
src/dod/Scene.h:25-31): parallel arrays for spheres and triangles plus a
deduplicated material table.

  * Spheres store ``centre``, ``radius_sq`` and ``centre_sq`` (|c|^2).
  * Triangles are stored as Woop affine transforms: a 3x4 matrix per
    triangle mapping world space to (u, v, w) barycentric-plane space.
    ``normals`` keeps the per-vertex normals used for interpolation
    (src/dod/Scene.cpp:99-113).

The builder implements the reference's duck-typed SceneBuilder contract
(addTriangle / addSphere / setEnvironmentColour, src/main/main.cpp:291-324)
so the scene catalog and OBJ loader drive it identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops.camera import Camera
from ..utils import tracing
from ..utils.native import morton_order
from .materials import MaterialInterner, MaterialSpec, MaterialTable


class SphereArrays(NamedTuple):
    centre: torch.Tensor  # [S, 3]
    radius_sq: torch.Tensor  # [S]
    centre_sq: torch.Tensor  # [S]  |centre|^2
    mat_id: torch.Tensor  # [S] int32


class TriangleArrays(NamedTuple):
    # Woop transform, packed [T, 3, 4]: world point x maps to
    # (u, v, w) = woop[:, :, :3] @ x + woop[:, :, 3].
    woop: torch.Tensor  # [T, 3, 4]
    normals: torch.Tensor  # [T, 3, 3] per-vertex normals (n0, n1, n2)
    mat_id: torch.Tensor  # [T] int32
    verts: torch.Tensor  # [T, 3, 3]


class Scene(NamedTuple):
    """Device-side SoA scene."""

    spheres: SphereArrays
    triangles: TriangleArrays
    materials: MaterialTable
    environment: torch.Tensor  # [3]

    @property
    def num_spheres(self) -> int:
        return self.spheres.centre.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.woop.shape[0]

    @property
    def device(self) -> torch.device:
        return self.environment.device

    def to(self, device) -> "Scene":
        return Scene(
            spheres=SphereArrays(*(f.to(device) for f in self.spheres)),
            triangles=TriangleArrays(*(f.to(device) for f in self.triangles)),
            materials=MaterialTable(*(f.to(device) for f in self.materials)),
            environment=self.environment.to(device),
        )


def _woop_from_verts(verts: np.ndarray) -> np.ndarray:
    """Per-triangle world->(u,v,w) affine transforms. verts: [T, 3, 3] f64."""
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0  # "uVector" (dod/TriangleVertices.h:24-26)
    e2 = verts[:, 2] - v0  # "vVector"
    n = np.cross(e1, e2)  # unnormalised face normal
    m = np.stack([e1, e2, n], axis=-1)  # [T, 3, 3] columns e1,e2,n
    # Degenerate triangles (zero area) get a transform that never accepts.
    dets = np.linalg.det(m)
    bad = np.abs(dets) < 1e-30
    if bad.any():
        m = m.copy()
        m[bad] = np.eye(3)
    minv = np.linalg.inv(m)  # [T, 3, 3] rows map x -> (u, v, w)
    trans = -np.einsum("tij,tj->ti", minv, v0)  # [T, 3]
    woop = np.concatenate([minv, trans[:, :, None]], axis=-1)  # [T, 3, 4]
    if bad.any():
        woop[bad] = 0.0  # w' == 0 everywhere -> rejected as parallel
    return woop


@dataclass
class SceneBuilder:
    """Host-side accumulation; ``build()`` freezes to device tensors."""

    _tri_verts: list = field(default_factory=list)
    _tri_normals: list = field(default_factory=list)
    _tri_mats: list = field(default_factory=list)
    _sph_centres: list = field(default_factory=list)
    _sph_radii: list = field(default_factory=list)
    _sph_mats: list = field(default_factory=list)
    _materials: MaterialInterner = field(default_factory=MaterialInterner)
    _environment: tuple = (0.0, 0.0, 0.0)

    def add_triangle(self, v0, v1, v2, material: MaterialSpec, normals=None):
        verts = np.array([v0, v1, v2], dtype=np.float64)
        if normals is None:
            # Default vertex normals to the face normal, as the reference does
            # (src/dod/Scene.cpp:181-187, src/oo/Triangle.cpp:43-47).
            e1 = verts[1] - verts[0]
            e2 = verts[2] - verts[0]
            n = np.cross(e1, e2)
            ln = np.linalg.norm(n)
            n = n / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
            normals = np.array([n, n, n])
        self._tri_verts.append(verts)
        self._tri_normals.append(np.asarray(normals, dtype=np.float64))
        self._tri_mats.append(self._materials.intern(material))

    def add_triangles_soa(self, verts, mat_rows, mat_ids) -> None:
        """Bulk triangle ingest from the native OBJ parser
        (utils/native.parse_obj_native): verts [n, 3, 3] f64, mat_rows
        [m, 9] = (emission 3, diffuse 3, ior, reflectivity, cone), mat_ids
        [n] int32 indices into mat_rows. The same scene as n add_triangle
        calls (face normals, material interning) without the Python loop."""
        verts = np.asarray(verts, np.float64)
        n = verts.shape[0]
        if n == 0:
            return
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-300), (0.0, 0.0, 1.0))
        normals = np.repeat(nrm[:, None, :], 3, axis=1)  # [n, 3, 3]
        local = [
            self._materials.intern(MaterialSpec(
                emission=(r[0], r[1], r[2]),
                diffuse=(r[3], r[4], r[5]),
                index_of_refraction=float(r[6]),
                reflectivity=float(r[7]),
                reflection_cone_angle_radians=float(r[8]),
            ))
            for r in np.asarray(mat_rows, np.float64)
        ]
        remap = (np.asarray(local, np.int32)[np.asarray(mat_ids, np.int32)]
                 if local else np.zeros(n, np.int32))
        self._tri_verts.extend(verts)
        self._tri_normals.extend(normals)
        self._tri_mats.extend(remap.tolist())

    def add_sphere(self, centre, radius: float, material: MaterialSpec):
        self._sph_centres.append(np.asarray(centre, dtype=np.float64).reshape(3))
        self._sph_radii.append(float(radius))
        self._sph_mats.append(self._materials.intern(material))

    def set_environment_colour(self, colour):
        c = np.asarray(colour, dtype=np.float64).reshape(3)
        self._environment = (float(c[0]), float(c[1]), float(c[2]))

    # camelCase aliases for reference-API familiarity
    addTriangle = add_triangle
    addSphere = add_sphere
    setEnvironmentColour = set_environment_colour

    @property
    def num_triangles(self) -> int:
        return len(self._tri_verts)

    @property
    def num_spheres(self) -> int:
        return len(self._sph_centres)

    @tracing.spanned("pt3.scene.build")
    def build(self, dtype=torch.float32, morton: bool = True,
              device="cpu") -> Scene:
        if self._tri_verts:
            verts = np.stack(self._tri_verts)  # [T, 3, 3]
            normals = np.stack(self._tri_normals)
            tri_mats = np.asarray(self._tri_mats, dtype=np.int32)
            if morton and len(self._tri_verts) > 64:
                # Spatial (Morton) ordering (native, or its Python form) so
                # consecutive triangle chunks are compact in space; oversized
                # triangles (backdrop quads) go at the end so they don't
                # inflate a chunk's box.
                diag = np.linalg.norm(
                    verts.max(axis=1) - verts.min(axis=1), axis=1
                )
                large = diag > 4.0 * max(np.median(diag), 1e-12)
                order = morton_order(verts.mean(axis=1))
                order = np.concatenate(
                    [order[~large[order]], order[large[order]]]
                )
                verts = verts[order]
                normals = normals[order]
                tri_mats = tri_mats[order]
            woop = _woop_from_verts(verts)
        else:
            verts = np.zeros((0, 3, 3))
            normals = np.zeros((0, 3, 3))
            woop = np.zeros((0, 3, 4))
            tri_mats = np.zeros((0,), dtype=np.int32)
        if self._sph_centres:
            centres = np.stack(self._sph_centres)
            radii = np.asarray(self._sph_radii)
            sph_mats = np.asarray(self._sph_mats, dtype=np.int32)
        else:
            centres = np.zeros((0, 3))
            radii = np.zeros((0,))
            sph_mats = np.zeros((0,), dtype=np.int32)
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        return Scene(
            spheres=SphereArrays(
                centre=f(centres),
                radius_sq=f(radii * radii),
                centre_sq=f(np.sum(centres * centres, -1)),
                mat_id=i(sph_mats),
            ),
            triangles=TriangleArrays(
                woop=f(woop),
                normals=f(normals),
                mat_id=i(tri_mats),
                verts=f(verts),
            ),
            materials=self._materials.build(dtype, device),
            environment=f(np.asarray(self._environment)),
        )


class StatsSceneBuilder:
    """Counting mock, as in the reference (src/main/main.cpp:311-324)."""

    def __init__(self):
        self.num_triangles = 0
        self.num_spheres = 0

    def add_triangle(self, *args, **kw):
        self.num_triangles += 1

    def add_sphere(self, *args, **kw):
        self.num_spheres += 1

    def set_environment_colour(self, *args, **kw):
        pass

    addTriangle = add_triangle
    addSphere = add_sphere
    setEnvironmentColour = set_environment_colour

    def report(self) -> str:
        return (
            f"Scene contains {self.num_triangles} triangles and "
            f"{self.num_spheres} spheres."
        )


def auto_epsilon(scene: Scene, camera) -> float:
    """Geometric epsilon from scene scale: 2^-12 x the median
    camera-to-primitive distance, clamped to [1e-4, 1e-3] — the float32
    grazing-sphere cancellation scale (``b - sqrt(det)`` loses ~|b| * 2^-12
    near det ~ 0)."""
    centres = []
    tv = scene.triangles.verts.detach().cpu().double().numpy()
    if tv.size:
        centres.append(tv.mean(axis=1))  # [T, 3] centroids
    sc = scene.spheres.centre.detach().cpu().double().numpy()
    if sc.size:
        centres.append(sc)
    if not centres:
        return 1e-4
    pts = np.concatenate(centres, axis=0)
    cam = camera.centre.detach().cpu().double().numpy().reshape(1, 3)
    med = float(np.median(np.linalg.norm(pts - cam, axis=1)))
    return float(np.clip(med * 2.0 ** -12, 1e-4, 1e-3))


_SCENE_KEYS = (
    "spheres.centre", "spheres.radius_sq", "spheres.centre_sq", "spheres.mat_id",
    "triangles.woop", "triangles.normals", "triangles.mat_id", "triangles.verts",
    "materials.emission", "materials.diffuse", "materials.ior",
    "materials.reflectivity", "materials.cone_angle", "environment",
)
_CAMERA_KEYS = tuple("camera." + f for f in Camera._fields)


def from_jax_arrays(d: dict, device="cpu") -> tuple[Scene, Camera]:
    """Scene and camera from the JAX package's ``Scene``/``Camera`` fields
    exported as numpy arrays, keyed ``"spheres.centre"``, ...,
    ``"environment"`` and ``"camera.centre"``, ... (the counterpart of
    carrying weights across: both sides then trace the same scene)."""
    missing = [k for k in _SCENE_KEYS + _CAMERA_KEYS if k not in d]
    if missing:
        raise KeyError(f"from_jax_arrays: missing {missing}")

    def t(k):
        a = np.asarray(d[k])
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    scene = Scene(
        spheres=SphereArrays(*(t("spheres." + f) for f in SphereArrays._fields)),
        triangles=TriangleArrays(*(t("triangles." + f) for f in TriangleArrays._fields)),
        materials=MaterialTable(*(t("materials." + f) for f in MaterialTable._fields)),
        environment=t("environment"),
    )
    camera = Camera(*(t(k) for k in _CAMERA_KEYS))
    return scene, camera
