"""The port's native host library (``utils/native.py`` over
``pt_three_ways_tpu_torch/csrc/pt3native.cpp``) against its Python
fallbacks and the JAX package, on the CPU.

  * The native OBJ/MTL parse of CornellBox-Original and suzanne equals the
    port's Python loader and the JAX package's ``load_obj_file``, vertex
    for vertex and material for material; malformed input raises the
    reference's wording.
  * The native Morton order equals the Python order and the JAX package's
    ``morton_order``, and it is spatially coherent.
  * The native ``.raw`` merge writes the bytes of the Python merge (and
    ``raw_to_png``'s PNG is that of the merge); a size mismatch raises.
  * The catalog scenes cornell, suzanne and ce build bit-identical scenes
    with ``PT3_NATIVE_OBJ=1`` and ``=0``, and equal to the JAX package's.

The library is built with g++ at first use; the file skips only when no
compiler exists.
"""

import os
import shutil

import numpy as np
import pytest

from pt_three_ways_tpu_torch.utils import native
from pt_three_ways_tpu_torch.utils.assets import scenes_dir
from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput, merge
from pt_three_ways_tpu_torch.utils.obj_loader import DirRelativeOpener, load_obj_file
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


@pytest.fixture(autouse=True)
def fresh_native(monkeypatch):
    """Each test loads the library anew (a test may force the fallbacks)."""
    monkeypatch.delenv("PT3_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.load() is not None


class Capture:
    def __init__(self):
        self.tris = []
        self.mats = []

    def add_triangle(self, v0, v1, v2, mat):
        self.tris.append(np.array([v0, v1, v2]))
        self.mats.append(mat)

    def add_sphere(self, *a):
        pass

    def set_environment_colour(self, *a):
        pass


def _python_parse(load, opener_cls, name):
    cap = Capture()
    opener = opener_cls(scenes_dir())
    with opener.open(name) as f:
        load(f, opener, cap)
    return cap


@pytest.mark.parametrize("name", ["CornellBox-Original.obj", "suzanne.obj"])
def test_native_obj_matches_python_and_jax(name):
    from pt_three_ways_tpu.utils.obj_loader import DirRelativeOpener as OpenerJ
    from pt_three_ways_tpu.utils.obj_loader import load_obj_file as load_j

    d = scenes_dir()
    verts, mat_ids, mats = native.parse_obj_native(os.path.join(d, name), d)
    for cap in (_python_parse(load_obj_file, DirRelativeOpener, name),
                _python_parse(load_j, OpenerJ, name)):
        assert verts.shape[0] == len(cap.tris)
        np.testing.assert_array_equal(verts, np.stack(cap.tris))
        for i, spec in enumerate(cap.mats):
            row = mats[mat_ids[i]]
            np.testing.assert_array_equal(row[0:3], spec.emission)
            np.testing.assert_array_equal(row[3:6], spec.diffuse)
            assert row[6] == spec.index_of_refraction
            assert row[7] == spec.reflectivity
            assert row[8] == spec.reflection_cone_angle_radians


def test_native_obj_error(tmp_path):
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nvq 1 2\n")
    with pytest.raises(ValueError, match="Unknown directive 'vq' on line 2"):
        native.parse_obj_native(str(bad), str(tmp_path))
    with pytest.raises(ValueError, match="Unknown directive 'vq' on line 2"):
        with open(bad) as f:
            load_obj_file(f, DirRelativeOpener(str(tmp_path)), Capture())


def test_morton_order_native_matches_python_and_jax(rng_np, monkeypatch):
    from pt_three_ways_tpu.utils.native import morton_order as morton_j

    from pt_three_ways_tpu_torch.utils.morton import morton_order as morton_py

    pts = rng_np.normal(size=(257, 3))
    a = native.morton_order(pts)
    np.testing.assert_array_equal(a, morton_py(pts))
    np.testing.assert_array_equal(a, morton_j(pts))
    monkeypatch.setenv("PT3_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.load() is None
    np.testing.assert_array_equal(native.morton_order(pts), a)
    assert sorted(a.tolist()) == list(range(257))


def test_morton_order_is_spatially_coherent():
    # points on a line come out in line order
    t = np.linspace(0, 1, 64)
    order = native.morton_order(np.stack([t, t, t], axis=1))
    assert (np.diff(order) > 0).all()


def test_native_raw_merge_matches_python(tmp_path, rng_np):
    from pt_three_ways_tpu_torch import raw_to_png
    from pt_three_ways_tpu_torch.utils.png import read_png

    paths, outs = [], []
    for i in range(3):
        a = ArrayOutput(6, 4)
        a.sum[:] = rng_np.normal(size=(4, 6, 3))
        a.count[:] = rng_np.integers(0, 50, size=(4, 6))
        paths.append(str(tmp_path / f"{i}.raw"))
        a.save(paths[-1])
        outs.append(a)
    got, want = str(tmp_path / "native.raw"), str(tmp_path / "python.raw")
    assert native.raw_merge_native(paths, got)
    merge(outs).save(want)
    assert open(got, "rb").read() == open(want, "rb").read()
    png = str(tmp_path / "m.png")
    assert raw_to_png.main([png, *paths]) == 0
    np.testing.assert_array_equal(read_png(png), merge(outs).to_srgb8())


def test_native_raw_merge_size_mismatch(tmp_path):
    pa, pb = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    ArrayOutput(2, 2).save(pa)
    ArrayOutput(3, 2).save(pb)
    with pytest.raises(IOError, match="differently-sized"):
        native.raw_merge_native([pa, pb], str(tmp_path / "o.raw"))


@pytest.mark.parametrize("scene_name", ["cornell", "suzanne", "ce"])
def test_catalog_native_obj_path_builds_identical_scene(scene_name, monkeypatch):
    """catalog._load_obj's native ingest (add_triangles_soa) builds the
    scene of the Python loader bit for bit, and the JAX package's."""
    from pt_three_ways_tpu.models.catalog import create_scene as create_j
    from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
    from pt_three_ways_tpu.utils.render_params import RenderParams as RPj

    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    def build(flag):
        monkeypatch.setenv("PT3_NATIVE_OBJ", flag)
        sb = SceneBuilder()
        create_scene(sb, scene_name, RenderParams(width=16, height=16))
        return sb.build()

    a, b = build("1"), build("0")
    sbj = SBj()
    create_j(sbj, scene_name, RPj(width=16, height=16))
    sj = sbj.build()
    for group in ("spheres", "triangles", "materials"):
        for field in getattr(a, group)._fields:
            x = getattr(getattr(a, group), field).numpy()
            np.testing.assert_array_equal(x, getattr(getattr(b, group), field).numpy())
            np.testing.assert_array_equal(x, np.asarray(getattr(getattr(sj, group), field)))
    np.testing.assert_array_equal(a.environment.numpy(), np.asarray(sj.environment))
