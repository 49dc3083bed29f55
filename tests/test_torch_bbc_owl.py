"""The bbc-owl configuration of the benchmark (``portbench/configs/bbc-owl.json``)
on the CPU, at a tiny size.

  * Its ``reference`` block states the scene that the port's catalog builds
    for ``bbc-owl``: 100 spheres and 12 triangles, their materials, the
    environment and the camera, within 1e-12 in float64.
  * The port's render through the kernels' plain versions agrees with the
    plain reference (``portbench/reference``) under the cell's limits.
  * The reference in bfloat16, put in the program's place, fails them.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from portbench import check, core
from portbench.reference import render as ref_render
from portbench.reference import scene as ref_scene
from portbench.reference.tracer import Geometry
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.materials import MaterialSpec
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_megakernel import one_torch_thread  # noqa: E402, F401 (autouse fixture)

CELL = "bbc-owl-frames-256-128spp"
CONFIG = json.load(open(os.path.join(core.HERE, "configs", "bbc-owl.json")))
LIMITS = json.load(open(os.path.join(core.HERE, "limits", CELL + ".json")))
W = H = 12
SPP = 2
SEED = 2 ** 33 + 4242


class _Recorder:
    """Records the spheres, triangles and environment the catalog adds, in float64."""

    def __init__(self):
        self.spheres, self.triangles, self.environment = [], [], None

    def add_sphere(self, centre, radius, material):
        self.spheres.append((np.asarray(centre, np.float64), float(radius), material))

    def add_triangle(self, a, b, c, material):
        self.triangles.append((np.asarray([a, b, c], np.float64), material))

    def set_environment_colour(self, colour):
        self.environment = np.asarray(colour, np.float64)


def _row(m: MaterialSpec) -> tuple:
    return m.emission + m.diffuse + (m.index_of_refraction, m.reflectivity,
                                     m.reflection_cone_angle_radians)


def test_reference_block_states_the_catalog_scene():
    params = RenderParams(width=256, height=256)
    rec = _Recorder()
    cam = create_scene(rec, "bbc-owl", params, dtype=torch.float64)
    rs = ref_scene.build(CONFIG, params.width, params.height)
    assert len(rec.spheres) == len(rs.radius) == 100
    assert len(rec.triangles) == len(rs.verts) == 12
    np.testing.assert_allclose(np.stack([s[0] for s in rec.spheres]), rs.centre, rtol=0, atol=1e-12)
    np.testing.assert_allclose([s[1] for s in rec.spheres], rs.radius, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.stack([t[0] for t in rec.triangles]), rs.verts, rtol=0,
                               atol=1e-12)
    mats = [_row(s[2]) for s in rec.spheres]
    np.testing.assert_allclose(mats, rs.materials[rs.sph_mat], rtol=0, atol=1e-12)
    mats = [_row(t[1]) for t in rec.triangles]
    np.testing.assert_allclose(mats, rs.materials[rs.tri_mat], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rec.environment, rs.environment, rtol=0, atol=1e-12)
    rc = rs.camera
    for port, ref in ((cam.centre, rc["eye"]), (cam.axis_x, rc["x"]), (cam.axis_y, rc["y"]),
                      (cam.axis_z, rc["z"]), (cam.aspect, rc["aspect"]),
                      (cam.plane_dist, rc["plane_dist"]), (cam.aperture, rc["aperture"]),
                      (cam.focal_dist, rc["focal_dist"])):
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-12)
    # 99 Fresnel owl spheres and the light; the floor's material is the third
    assert sorted(np.unique(rs.sph_mat, return_counts=True)[1]) == [1, 99]
    assert len(rs.materials) == 3


def _reference(dtype):
    rs = ref_scene.build(CONFIG, W, H)
    ys, xs = np.mgrid[0:H, 0:W]
    ref, _ = ref_render.pixel_means(rs, Geometry(rs, "cpu", dtype), W, H, SPP,
                                    CONFIG["max_depth"], CONFIG["first_bounce_u"],
                                    CONFIG["first_bounce_v"], [(SEED, xs.ravel(), ys.ravel())],
                                    "cpu")
    return rs, ref


@pytest.fixture(scope="module")
def renders():
    """The port's CPU render (the kernels' plain versions) and the
    reference's float64 pixel means of the same frame."""
    from pt_three_ways_tpu_torch.models.render import render

    params = RenderParams(width=W, height=H, samples_per_pixel=SPP, seed=SEED,
                          max_depth=CONFIG["max_depth"],
                          first_bounce_u_samples=CONFIG["first_bounce_u"],
                          first_bounce_v_samples=CONFIG["first_bounce_v"],
                          intersector="kernel")
    sb = SceneBuilder()
    cam = create_scene(sb, CONFIG["scene"], params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, cam))
    out = render(scene, cam, params, device="cpu")
    prog = (out.sum / out.count[..., None]).reshape(-1, 3)
    rs, ref = _reference(torch.float64)
    assert rs.epsilon == pytest.approx(params.epsilon, rel=1e-6)
    return prog, ref


def test_port_render_agrees_with_the_reference(renders):
    prog, ref = renders
    nums = check.pixels(prog, ref)
    assert nums["pixels_off"] <= LIMITS["pixels_off"] and nums["median_gap"] <= LIMITS["median_gap"]
    assert nums["median_gap"] < 1e-6  # the same draws: float32 rounding alone


def test_bfloat16_reference_fails_the_limits(renders):
    _, ref = renders
    _, low = _reference(torch.bfloat16)
    nums = check.pixels(low, ref)
    assert nums["pixels_off"] > LIMITS["pixels_off"] or nums["median_gap"] > LIMITS["median_gap"]
