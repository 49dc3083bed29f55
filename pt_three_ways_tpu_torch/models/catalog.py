"""Built-in scene catalog — the reference's 7 scenes (src/main/main.cpp:70-309).

Each ``create_*`` function drives a duck-typed builder (real SceneBuilder,
StatsSceneBuilder, or a test fake) and returns the Camera, exactly like the
reference's templated createScene dispatch (main.cpp:291-309).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .materials import MaterialSpec
from ..ops.camera import Camera, make_camera, set_focus
from ..utils import tracing
from ..utils.assets import scenes_dir
from ..utils.obj_loader import DirRelativeOpener, load_obj_file


def hex_colour(hex_value: int):
    """De-gamma'd hex colour (main.cpp:40-43)."""

    def c(x):
        return ((x & 0xFF) / 255.0) ** 2.2

    return (c(hex_value >> 16), c(hex_value >> 8), c(hex_value))


def add_cube(builder, low, high, material: MaterialSpec) -> None:
    """12-triangle axis-aligned cuboid (main.cpp:46-67)."""
    low = np.asarray(low, np.float64)
    high = np.asarray(high, np.float64)

    def t(bit):
        x = bool(bit & 4)
        y = bool(bit & 2)
        z = bool(bit & 1)
        return np.array(
            [
                low[0] if x else high[0],
                low[1] if y else high[1],
                low[2] if z else high[2],
            ]
        )

    quads = [
        (0b000, 0b100, 0b110, 0b010),
        (0b001, 0b101, 0b111, 0b011),
        (0b000, 0b100, 0b101, 0b001),
        (0b010, 0b110, 0b111, 0b011),
        (0b000, 0b010, 0b011, 0b001),
        (0b100, 0b110, 0b111, 0b101),
    ]
    for a, b, c, d in quads:
        builder.add_triangle(t(a), t(b), t(c), material)
        builder.add_triangle(t(a), t(c), t(d), material)


def _load_obj(builder, filename: str) -> None:
    sdir = scenes_dir()
    # Native bulk ingest (csrc/pt3native.cpp): the same scene as the Python
    # loader (errors included), taken when the builder supports SoA ingest.
    # PT3_NATIVE_OBJ=0 forces the Python parser alone (PT3_NO_NATIVE=1
    # forces every Python path): the scene's other native step, build()'s
    # Morton order, stays as it is, so a comparison of the two parsers'
    # scenes sees the parsers and nothing else.
    if os.environ.get("PT3_NATIVE_OBJ", "1") != "0" and hasattr(
        builder, "add_triangles_soa"
    ):
        from ..utils.native import parse_obj_native

        parsed = parse_obj_native(os.path.join(sdir, filename), sdir)
        if parsed is not None:
            verts, mat_ids, mats = parsed
            builder.add_triangles_soa(verts, mats, mat_ids)
            return
    opener = DirRelativeOpener(sdir)
    with opener.open(filename) as stream:
        load_obj_file(stream, opener, builder)


def create_cornell_scene(builder, params, dtype=torch.float32) -> Camera:
    """main.cpp:70-86."""
    _load_obj(builder, "CornellBox-Original.obj")
    builder.add_sphere(
        (-0.38, 0.281, 0.38),
        0.28,
        MaterialSpec.make_reflective((0.999, 0.999, 0.999), 0.95, 5),
    )
    builder.set_environment_colour(np.array([0.725, 0.71, 0.68]) * 0.1)
    camera = make_camera(
        (0, 1, 3), (0, 1, 0), (0, 1, 0), params.width, params.height, 50.0, dtype
    )
    return set_focus(camera, (0, 0, 0), 0.01)


def create_suzanne_scene(builder, params, dtype=torch.float32) -> Camera:
    """main.cpp:89-114."""
    _load_obj(builder, "suzanne.obj")
    light = MaterialSpec.make_light((4, 4, 4))
    builder.add_sphere((0.5, 1, 3), 1, light)
    builder.add_sphere((1, 1, 3), 1, light)
    box_mat = MaterialSpec.make_diffuse((0.20, 0.30, 0.36))
    tl, tr = (-5, -5, -1), (5, -5, -1)
    bl, br = (-5, 5, -1), (5, 5, -1)
    builder.add_triangle(tl, tr, bl, box_mat)
    builder.add_triangle(tr, bl, br, box_mat)
    camera = make_camera(
        (1, -0.45, 4), (1, -0.6, 0.4), (0, 1, 0),
        params.width, params.height, 40.0, dtype,
    )
    return set_focus(camera, (1, -0.6, 0.4), 0.01)


def create_ce_scene(builder, params, dtype=torch.float32) -> Camera:
    """main.cpp:117-137."""
    _load_obj(builder, "ce.obj")
    builder.add_sphere((0, 1.6, 0), 1.0, MaterialSpec.make_light((10, 10, 10)))
    builder.add_sphere(
        (-0.2, 5.9, -0.3),
        5.0,
        MaterialSpec.make_light(np.array([2.27, 3, 2.97]) * 0.25),
    )
    builder.add_sphere((0, 0, 0), 10, MaterialSpec.make_diffuse((0.2, 0.2, 0.2)))
    camera = make_camera(
        (0.27, 1.15, 0.36), (0, 0, 0), (0, 0, -1),
        params.width, params.height, 40.0, dtype,
    )
    return set_focus(camera, (0, 0, 0), 0.01)


def create_single_sphere_scene(builder, params, dtype=torch.float32) -> Camera:
    """main.cpp:140-163."""
    cam_pos = np.array([0.0, 0.0, -3.2])
    camera = make_camera(
        cam_pos, (0, 0, 0), (0, 1, 0), params.width, params.height, 40.0, dtype
    )
    light_radius = 3.0
    light_offset = np.array([6.0, 6.0, 0.0])
    builder.add_sphere(
        cam_pos + light_offset - np.array([0, 0, light_radius]),
        light_radius,
        MaterialSpec.make_light((8, 8, 8)),
    )
    sphere_mat = MaterialSpec.make_diffuse((0.2, 0.2, 0.2)).replace(
        index_of_refraction=1.3, reflection_cone_angle_radians=0.05
    )
    builder.add_sphere((0, 0, 0), 1, sphere_mat)
    builder.add_sphere((0, 0, 0), 10, MaterialSpec.make_diffuse((0.2, 0.2, 0.5)))
    return camera


def create_multi_sphere_scene(builder, params, dtype=torch.float32) -> Camera:
    """9x5 material-sweep grid (main.cpp:166-196)."""
    cam_pos = np.array([0.0, 0.0, -3.2])
    camera = make_camera(
        cam_pos, (0, 0, 0), (0, 1, 0), params.width, params.height, 40.0, dtype
    )
    light_radius = 3.0
    light_offset = np.array([6.0, 6.0, 0.0])
    builder.add_sphere(
        cam_pos + light_offset - np.array([0, 0, light_radius]),
        light_radius,
        MaterialSpec.make_light((8, 8, 8)),
    )
    sphere_radius = 1.0 / 5.0
    sphere_gap = sphere_radius * 2.15
    for y in range(-2, 3):
        for x in range(-4, 5):
            mat = MaterialSpec.make_diffuse((0.90, 0.91, 0.92)).replace(
                reflection_cone_angle_radians=0.075 * (x + 4),
                index_of_refraction=1.0 + 0.15 * (y + 2),
            )
            builder.add_sphere(
                (x * sphere_gap, y * sphere_gap, 0), sphere_radius, mat
            )
    builder.add_sphere((0, 0, 0), 10, MaterialSpec.make_diffuse((0.2, 0.2, 0.5)))
    return camera


def create_example1_scene(builder, params, dtype=torch.float32) -> Camera:
    """fogleman/pt example1 homage (main.cpp:199-225)."""
    builder.add_sphere(
        (1.5, 1.25, 0), 1.25, MaterialSpec.make_specular(hex_colour(0x004358), 1.3)
    )
    builder.add_sphere(
        (-1, 1, 2), 1.0, MaterialSpec.make_specular(hex_colour(0xFFE11A), 1.3)
    )
    builder.add_sphere(
        (-2.5, 0.75, 0), 0.75, MaterialSpec.make_specular(hex_colour(0xFD7400), 1.3)
    )
    builder.add_sphere(
        (-0.75, 0.5, -1), 0.5, MaterialSpec.make_specular(hex_colour(0), 1.3)
    )
    add_cube(
        builder,
        (-10, -1, -10),
        (10, 0, 10),
        MaterialSpec.make_glossy((1, 1, 1), 1.1, 10.0),
    )
    builder.add_sphere((-1.5, 4, 0), 0.5, MaterialSpec.make_light((30, 30, 30)))
    camera = make_camera(
        (0, 2, -5), (0, 0.25, 3), (0, 1, 0), params.width, params.height, 45.0, dtype
    )
    return set_focus(camera, (-0.75, 1, -1), 0.1)


_OWL = [
    "* * * * * * * * *",
    " *     * *     * ",
    "*   *   *   *   *",
    "   * *     * *   ",
    "*   *       *   *",
    " *     * *     * ",
    "* *     *     * *",
    " * *         *   ",
    "* * * * * * *   *",
    " * * * *         ",
    "* * * * *       *",
    " * * * *         ",
    "  * * * *       *",
    "   * * * *       ",
    "    * * * *     *",
    "     * * * *     ",
    "      * * * *   *",
    "       * * * *   ",
    "      *   *   * *",
    " * * * * * *   * ",
    "                *",
]


def create_bbc_owl_scene(builder, params, dtype=torch.float32) -> Camera:
    """ASCII-art sphere layout (main.cpp:228-289)."""
    owl_height = len(_OWL)
    owl_width = len(_OWL[0])
    sphere_spacing = 0.1
    sphere_size = sphere_spacing * 0.7
    y = owl_height * sphere_spacing - sphere_spacing / 2
    mat = MaterialSpec.make_specular(hex_colour(0xFEFFD5), 1.3)
    for line in _OWL:
        x = owl_width * sphere_spacing / 2
        for c in line:
            if c == "*":
                builder.add_sphere((x, y, 0), sphere_size, mat)
            x -= sphere_spacing
        y -= sphere_spacing
    plane_mat = MaterialSpec.make_reflective((0.2, 0.2, 0.2), 0.75, 3.0).replace(
        index_of_refraction=1.5
    )
    add_cube(builder, (-10, -1, -10), (10, 0, 10), plane_mat)
    builder.add_sphere((-1.5, 4.0, -1), 0.75, MaterialSpec.make_light((30, 30, 30)))
    builder.set_environment_colour(np.array([0.2, 0.2, 0.5]) * 0.05)
    camera = make_camera(
        (4, 2.0, -5), (0, 0.5, 0), (0, 1, 0), params.width, params.height, 33.0, dtype
    )
    return set_focus(camera, (0, 0.5, 0), 0.1)


SCENES = {
    "cornell": create_cornell_scene,
    "suzanne": create_suzanne_scene,
    "ce": create_ce_scene,
    "single-sphere": create_single_sphere_scene,
    "multi-sphere": create_multi_sphere_scene,
    "example1": create_example1_scene,
    "bbc-owl": create_bbc_owl_scene,
}


# Per-scene tuning hint tables, identical to the JAX package's. Nothing
# reads them at render time: they are the oracle that pins
# models/render.autotune_decisions to the catalog's tuned rows
# (tests/test_torch_render.py). The optima behind them were chosen on the
# JAX package's hardware; the port re-measures them on its own card.
PASSES_PER_DISPATCH_HINT = {
    "cornell": 8, "suzanne": 64, "ce": 64, "bbc-owl": 64,
}

FEEDBACK_SORT_HINT = {
    "suzanne": True, "bbc-owl": True,
    "suzanne-sub2": True, "suzanne-sub3": True, "suzanne-sub4": True,
}

REGEN_TAIL_FRAC_HINT = {"suzanne": 0.125, "bbc-owl": 0.125}

# Per-scene geometric epsilon overrides (empty: models/scene.auto_epsilon
# derives every catalog scene's value).
EPSILON_HINT = {}

RNG_MODE_HINT = {"cornell": "table"}


def _subdivide_soa(verts: np.ndarray, mat_ids: np.ndarray, levels: int):
    """1:4 midpoint subdivision, vectorised. verts [T, 3, 3] -> [4^L*T, 3, 3].

    Children tile the parent exactly (same planes, same winding, same
    material), so the rendered image is statistically identical to the
    unsubdivided mesh — which makes ``-subN`` scenes a pure scene-SIZE
    scaling axis for the intersector (VERDICT round 2 Missing #1: the
    reference's linear scan is unbounded in N, src/dod/Scene.cpp:51-113).
    """
    for _ in range(levels):
        v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
        a = (v0 + v1) * 0.5
        b = (v1 + v2) * 0.5
        c = (v2 + v0) * 0.5
        verts = np.stack(
            [
                np.stack([v0, a, c], axis=1),
                np.stack([a, v1, b], axis=1),
                np.stack([c, b, v2], axis=1),
                np.stack([a, b, c], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3, 3)
        mat_ids = np.repeat(mat_ids, 4)
    return verts, mat_ids


class _SubdividingBuilder:
    """Builder proxy that 1:4-subdivides every triangle ``levels`` times.

    Spheres, materials and the environment pass through untouched. The SoA
    bulk-ingest path is intercepted too, so the native OBJ parser keeps
    working; ``hasattr(proxy, "add_triangles_soa")`` mirrors the inner
    builder via __getattr__.
    """

    def __init__(self, inner, levels: int):
        self._inner = inner
        self._levels = levels

    def add_triangle(self, v0, v1, v2, mat):
        verts = np.asarray([v0, v1, v2], np.float64)[None]
        verts, _ = _subdivide_soa(verts, np.zeros(1, np.int32), self._levels)
        for child in verts:
            self._inner.add_triangle(child[0], child[1], child[2], mat)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)  # AttributeError mirrors inner
        if name == "add_triangles_soa":
            def soa(verts, mats, mat_ids):
                v, m = _subdivide_soa(
                    np.asarray(verts, np.float64),
                    np.asarray(mat_ids, np.int32),
                    self._levels,
                )
                return attr(v, mats, m)

            return soa
        return attr


def hint_key(scene_name: str) -> str:
    """Key for the per-scene tuning hint tables: a ``-subN`` subdivided
    scene is the same geometry/lighting as its base, so it inherits the
    base scene's measured optima (ppd, feedback sort, tail frac, rng mode,
    epsilon)."""
    base, sep, sub = scene_name.partition("-sub")
    if sep and sub.isdigit() and base in SCENES:
        return base
    return scene_name


@tracing.spanned("pt3.scene.build")
def create_scene(builder, scene_name: str, params, dtype=torch.float32) -> Camera:
    """Dispatch (main.cpp:291-309). A ``-subN`` suffix (e.g. suzanne-sub3)
    renders the base scene with every triangle midpoint-subdivided N times
    (x4^N triangles, statistically identical image) — the scene-size
    scaling axis for intersector benchmarks."""
    base, sep, sub = scene_name.partition("-sub")
    if sep and sub.isdigit() and base in SCENES:
        builder = _SubdividingBuilder(builder, int(sub))
        scene_name = base
    try:
        factory = SCENES[scene_name]
    except KeyError:
        raise ValueError(f"Unknown scene {scene_name}") from None
    return factory(builder, params, dtype)
