"""A configuration's scene, built from its own file and the raw OBJ/MTL.

The reference builds the scene from what the configuration file states
(the upstream catalog entry: OBJ file, spheres, extra triangles,
environment, camera) and from ``scenes/*.obj``, the raw files that the
program reads too. Every primitive carries its material as a tuple
(emission 3, diffuse 3, ior, reflectivity, cone angle), float64; the
material table is the set of distinct tuples, which is how the program
deduplicates its materials too, so a gradient per table row means the
same on both sides (rows may come in another order).

Face normals throughout: the OBJ loader of the upstream program reads
``v``/``f`` only, and its triangles' vertex normals are the face normal.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def material(spec: dict) -> tuple:
    """A material tuple from a config entry: ``emission``, ``diffuse``,
    ``ior`` (1.0), ``reflectivity`` (-1: Fresnel), ``cone_degrees`` (0)."""
    em = tuple(float(x) for x in spec.get("emission", (0.0, 0.0, 0.0)))
    di = tuple(float(x) for x in spec.get("diffuse", (0.0, 0.0, 0.0)))
    cone = float(spec.get("cone_degrees", 0.0)) / 360.0 * 2.0 * math.pi
    return em + di + (float(spec.get("ior", 1.0)), float(spec.get("reflectivity", -1.0)), cone)


def _mtl(path: str) -> dict:
    """Upstream MTL rules: Ke, Kd, Ni; Ns -> cone pi * clamp(1 - Ns/100);
    ``illum 3`` makes the reflectivity |Ka| when the material closes (the
    illum and Ka seen last, as upstream keeps them across materials)."""
    mats, cur, illum, ambient = {}, None, 2, (0.0, 0.0, 0.0)

    def close():
        if cur is not None and illum == 3:
            cur["refl"] = float(np.linalg.norm(ambient))

    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            cmd, a = tok[0], tok[1:]
            if cmd == "newmtl":
                close()
                cur = dict(em=(0.0, 0.0, 0.0), di=(0.0, 0.0, 0.0), ior=1.0, refl=-1.0, cone=0.0)
                mats[a[0]] = cur
            elif cmd == "Ke":
                cur["em"] = tuple(float(x) for x in a)
            elif cmd == "Kd":
                cur["di"] = tuple(float(x) for x in a)
            elif cmd == "Ka":
                ambient = tuple(float(x) for x in a)
            elif cmd == "Ni":
                cur["ior"] = float(a[0])
            elif cmd == "Ns":
                cur["cone"] = math.pi * min(max(1.0 - float(a[0]) / 100.0, 0.0), 1.0)
            elif cmd == "illum":
                illum = int(a[0])
    close()
    return {k: v["em"] + v["di"] + (v["ior"], v["refl"], v["cone"]) for k, v in mats.items()}


def _obj(path: str):
    """Triangles (fan-triangulated faces) and their material tuples."""
    verts, tris, mats = [], [], []
    table, cur = {}, (0.0,) * 6 + (1.0, -1.0, 0.0)
    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            cmd, a = tok[0], tok[1:]
            if cmd == "v":
                verts.append([float(x) for x in a])
            elif cmd == "f":
                idx = [int(p.split("/")[0]) for p in a]
                idx = [i + len(verts) if i < 0 else i - 1 for i in idx]
                for i in range(1, len(idx) - 1):
                    tris.append([verts[idx[0]], verts[idx[i]], verts[idx[i + 1]]])
                    mats.append(cur)
            elif cmd == "mtllib":
                table = _mtl(os.path.join(os.path.dirname(path), a[0]))
            elif cmd == "usemtl":
                cur = table[a[0]]
    return tris, mats


@dataclass
class RefScene:
    verts: np.ndarray  # [T, 3, 3] float64
    tri_mat: np.ndarray  # [T] index into materials
    centre: np.ndarray  # [S, 3]
    radius: np.ndarray  # [S]
    sph_mat: np.ndarray  # [S]
    materials: np.ndarray  # [M, 9] distinct material tuples
    environment: np.ndarray  # [3]
    camera: dict  # float64 eye, x, y, z, aspect, plane_dist, aperture, focal_dist, w, h
    epsilon: float


def camera(cfg: dict, width: int, height: int) -> dict:
    """Upstream Camera: basis fromZY(normalise(look - eye), up), plane
    distance 1 / tan(fov pi / 360), focus at |focus - eye|."""
    eye = np.asarray(cfg["eye"], np.float64)
    up = np.asarray(cfg["up"], np.float64)
    up = up / np.linalg.norm(up)
    z = np.asarray(cfg["look_at"], np.float64) - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    focus = cfg.get("focus")
    return dict(eye=eye, x=x, y=y, z=z, aspect=width / height,
                plane_dist=1.0 / math.tan(cfg["fov_degrees"] * math.pi / 360.0),
                aperture=float(cfg.get("aperture", 0.0)),
                focal_dist=float(np.linalg.norm(np.asarray(focus) - eye)) if focus else 0.0,
                w=width, h=height)


def build(cfg: dict, width: int, height: int) -> RefScene:
    """The scene of a configuration file's ``reference`` entry."""
    ref = cfg["reference"]
    tris, tmats = _obj(os.path.join(ROOT, ref["obj"])) if ref.get("obj") else ([], [])
    for t in ref.get("triangles", []):
        tris.append(t["verts"])
        tmats.append(material(t["material"]))
    spheres = ref.get("spheres", [])
    smats = [material(s["material"]) for s in spheres]
    table = list(dict.fromkeys(tmats + smats))
    row = {m: i for i, m in enumerate(table)}
    env = np.asarray(ref.get("environment", (0.0, 0.0, 0.0)), np.float64) \
        * float(ref.get("environment_scale", 1.0))
    verts = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    centre = np.asarray([s["centre"] for s in spheres], np.float64).reshape(-1, 3)
    cam = camera(ref["camera"], width, height)
    return RefScene(
        verts=verts, tri_mat=np.asarray([row[m] for m in tmats], np.int64),
        centre=centre, radius=np.asarray([s["radius"] for s in spheres], np.float64),
        sph_mat=np.asarray([row[m] for m in smats], np.int64),
        materials=np.asarray(table, np.float64).reshape(-1, 9), environment=env,
        camera=cam, epsilon=epsilon(cfg, verts, centre, cam["eye"]))


def epsilon(cfg: dict, verts, centre, eye) -> float:
    """The configuration's epsilon: a number, or ``"auto"``: 2^-12 of the
    median distance from the camera to the triangles' centroids and the
    spheres' centres, clamped to [1e-4, 1e-3]."""
    rule = cfg["epsilon"]
    if rule != "auto":
        return float(rule)
    pts = np.concatenate([verts.mean(axis=1), centre])
    if not len(pts):
        return 1e-4
    med = float(np.median(np.linalg.norm(pts - eye[None], axis=1)))
    return float(np.clip(med * 2.0 ** -12, 1e-4, 1e-3))
