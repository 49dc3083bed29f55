"""The port's ``oo`` and ``fp`` ways (models/ways.py) and ``raw_to_png``
against the JAX package, on the CPU.

The JAX side runs jitted, as its render runs it (eager JAX rounds
differently from its compiled CPU code, which the port's CPU rounding
follows, ops/xla_cpu.py). Tolerances:

  * ``oo`` bit for bit;
  * ``fp`` within 1e-6, bit for bit on at least 80 % of the pixels: XLA's
    CPU code orders and contracts the recursion's products and sums in a
    way the port does not follow everywhere, which moves some pixels in
    their last bits;
  * each way against the port's ``dod`` within 2e-5 (the JAX package's own
    cross-way test: the same streams, another order of float sums);
  * ``intersector="kernel"`` (K2's plain version) against ``"xla"`` within
    2e-5 (the same winners; hit points differ in the last bits);
  * ``render(way=...)`` bit for bit, and the train step's loss within rtol
    1e-5 and material updates within 1e-4 of the largest (the gates of
    tests/test_torch_train.py);
  * ``raw_to_png``: the same printed lines and PNG bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models import ways as ways_j
from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.materials import MaterialSpec as MSj
from pt_three_ways_tpu.models.render import render as render_j
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.camera import make_camera as camera_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch import raw_to_png
from pt_three_ways_tpu_torch.cli import main as cli_main
from pt_three_ways_tpu_torch.models import ways
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.materials import MaterialSpec
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, from_jax_arrays
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.ops.camera import make_camera
from pt_three_ways_tpu_torch.utils.render_params import RenderParams
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_replay import jax_arrays

SIDE = 16
# two substrata and three bounces: XLA's compile time of the unrolled ``fp``
# recursion grows with both (tens of seconds at K=4, depth 5)
KW = dict(width=SIDE, height=SIDE, samples_per_pixel=1, max_depth=4,
          first_bounce_u_samples=2, first_bounce_v_samples=1, seed=42)


def _spheres_scene(sb, ms):
    """tests/test_integrator.py TestWaysAgree's scene: spheres (diffuse,
    glossy, a light) and a specular triangle."""
    sb.add_sphere((0, 1, 5), 1.0, ms.make_diffuse((0.7, 0.3, 0.2)))
    sb.add_sphere((0, -2, 5), 1.5, ms.make_reflective((0.9,) * 3, 0.8, 5))
    sb.add_sphere((3, 3, 3), 1.0, ms.make_light((5, 5, 5)))
    sb.add_triangle((-9, -4, 9), (9, -4, 9), (0, -4, -9), ms.make_specular((0.5, 0.5, 0.8), 1.3))
    sb.set_environment_colour((0.05, 0.05, 0.1))
    return sb.build()


def _pair(name):
    """(JAX scene, camera, port scene, camera) of one scene."""
    if name == "spheres":
        sj = _spheres_scene(SBj(), MSj)
        st = _spheres_scene(SceneBuilder(), MaterialSpec)
        eye = ((0, 0, -2), (0, 0, 5), (0, 1, 0), SIDE, SIDE, 60.0)
        return sj, camera_j(*eye), st, make_camera(*eye)
    bj = SBj()
    cam_j = create_j(bj, name, RPj(**KW))
    sj = bj.build()
    st, cam_t = from_jax_arrays(jax_arrays(sj, cam_j))
    return sj, cam_j, st, cam_t


def _grid():
    xs = np.tile(np.arange(SIDE, dtype=np.int32), SIDE)
    ys = np.repeat(np.arange(SIDE, dtype=np.int32), SIDE)
    return xs, ys


_JAX = {}


def _jax_pass(name, way, **kw):
    """The jitted JAX pass (pass key 1 of seed 42), cached per case."""
    key = (name, way, tuple(sorted({**KW, **kw}.items())))
    if key not in _JAX:
        sj, cam_j, _, _ = _pair(name)
        xs, ys = _grid()
        p = RPj(**{**KW, **kw})
        fn = jax.jit(lambda k: ways_j.WAYS[way](sj, cam_j, p, k, jnp.asarray(xs),
                                                jnp.asarray(ys)))
        _JAX[key] = np.asarray(fn(rj.pass_key(rj.base_key(42), 1)))
    return _JAX[key]


def _port_pass(name, way, **kw):
    _, _, st, cam_t = _pair(name)
    xs, ys = _grid()
    p = RenderParams(**{**KW, **kw})
    out = ways.WAYS[way](st, cam_t, p, rt.pass_key(rt.base_key(42), 1),
                         torch.from_numpy(xs), torch.from_numpy(ys))
    return out.numpy()


@pytest.mark.parametrize("name", ["spheres", "cornell"])
@pytest.mark.parametrize("way", ["oo", "fp"])
def test_way_matches_jax(name, way):
    ref = _jax_pass(name, way)
    got = _port_pass(name, way)
    assert got.shape == (SIDE * SIDE, 3) and np.isfinite(got).all()
    if way == "fp":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert (got == ref).all(axis=1).mean() >= 0.8
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["spheres", "cornell"])
@pytest.mark.parametrize("way", ["oo", "fp"])
def test_way_matches_port_dod(name, way):
    np.testing.assert_allclose(_port_pass(name, way), _port_pass(name, "dod"), atol=2e-5)


@pytest.mark.parametrize("way", ["oo", "fp"])
def test_kernel_intersector_matches_xla(way):
    """The ways' intersections on K2's plain version (camera rays, then every
    substratum and bounce, dead lanes with live=False)."""
    got = _port_pass("cornell", way, intersector="kernel")
    np.testing.assert_allclose(got, _port_pass("cornell", way, intersector="xla"),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("way", ["oo", "fp"])
def test_preview_matches_jax_and_dod(way):
    got = _port_pass("spheres", way, preview=True)
    np.testing.assert_array_equal(got, _port_pass("spheres", "dod", preview=True))
    np.testing.assert_array_equal(got, _jax_pass("spheres", way, preview=True))


def test_aliases():
    assert ways.WAYS["megakernel"] is ways.trace_pass_oo
    assert ways.WAYS["functional"] is ways.trace_pass_fp
    assert ways.WAYS["wavefront"] is ways.WAYS["dod"]
    assert set(ways.WAYS) == set(ways_j.WAYS)


RENDER_KW = dict(width=SIDE, height=SIDE, samples_per_pixel=2, seed=5, max_depth=3,
                 first_bounce_u_samples=2, first_bounce_v_samples=1)


def _render_cornell(way):
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", RenderParams(**RENDER_KW))
    return render(sb.build(), camera, RenderParams(**RENDER_KW), way=way,
                  device="cpu").mean()


@pytest.mark.parametrize("way", ["oo", "fp"])
def test_render_loop_matches_jax(way):
    kw = RENDER_KW
    sb = SBj()
    cam = create_j(sb, "cornell", RPj(**kw))
    ref = render_j(sb.build(), cam, RPj(**kw), way=way).mean()
    got = _render_cornell(way)
    assert got.shape == (SIDE, SIDE, 3)
    if way == "fp":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)
    alias = {"oo": "megakernel", "fp": "functional"}[way]
    np.testing.assert_array_equal(_render_cornell(alias), got)


@pytest.mark.parametrize("way", ["oo", "fp"])
def test_train_step_way_matches_jax(way):
    """``fused="off"`` with ``way=``: the port's step (the way's pass on K2's
    plain version, differentiated by autograd through K2's VJP) against
    the JAX step on a 1x1 mesh (its XLA intersector: the same winners)."""
    from pt_three_ways_tpu.parallel.mesh import make_mesh
    from pt_three_ways_tpu.parallel.train import TrainState as TSj
    from pt_three_ways_tpu.parallel.train import make_sharded_train_step as step_j
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
    from test_torch_train import LR, _assert_updates_close, _target

    side = 6
    kw = dict(width=side, height=side, samples_per_pixel=1, seed=9, max_depth=3,
              first_bounce_u_samples=2, first_bounce_v_samples=1)
    bj = SBj()
    cam_j = create_j(bj, "cornell", RPj(**kw))
    sj = bj.build()
    st, cam_t = from_jax_arrays(jax_arrays(sj, cam_j))
    px = np.arange(side * side, dtype=np.int32) % side
    py = np.arange(side * side, dtype=np.int32) // side
    target = _target(px.size, 6)
    sj_step = step_j(sj, RPj(intersector="xla", **kw), make_mesh(n_devices=1), way=way,
                     learning_rate=LR, fused="off")
    st_step = make_sharded_train_step(st, RenderParams(intersector="kernel", **kw), way=way,
                                      learning_rate=LR, fused="off", device="cpu")
    loss_j, new_j = sj_step(TSj(sj.materials, cam_j, jnp.int32(0)), rj.base_key(8),
                            jnp.asarray(px), jnp.asarray(py), jnp.asarray(target))
    loss_t, new_t = st_step(TrainState(st.materials, cam_t, 0), rt.base_key(8),
                            torch.from_numpy(px), torch.from_numpy(py),
                            torch.from_numpy(target))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_updates_close(new_t.materials, new_j.materials, sj.materials,
                          new_j.materials._fields)
    assert float((new_t.materials.diffuse - st.materials.diffuse).abs().sum()) > 0.0


@pytest.mark.parametrize("way", ["oo", "fp"])
def test_train_step_way_matches_dod_with_float64_sums(way, monkeypatch):
    """``fused="off"``: the way's material gradients against ``dod``'s, with
    each material row's gradient summed over the lanes in float64 (the same
    float32 values, gathered from a float64 copy of the table) and in
    float32. The float64 sums agree to 1e-6 of the norm; the float32 sums
    differ by no more than that plus each way's own float32 rounding (its
    float32 sums against its float64 sums)."""
    from pt_three_ways_tpu_torch.models import integrator
    from pt_three_ways_tpu_torch.parallel import train
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    params = RenderParams(width=SIDE, height=SIDE, max_depth=3, seed=1,
                          first_bounce_u_samples=2, first_bounce_v_samples=2)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    px, py = (torch.from_numpy(a) for a in _grid())
    target = torch.full((px.shape[0], 3), 0.25)
    gather32 = integrator.gather_materials

    def gather64(table, mat_id):
        g = gather32(type(table)(*(m.double() for m in table)), mat_id)
        return integrator.GatheredMat(*(f.float() for f in g))

    grads = {}
    for w in ("dod", way):
        for f64 in (False, True):
            got = []
            grads_of = train._grads
            monkeypatch.setattr(train, "_grads",
                                lambda *a: got.append(grads_of(*a)) or got[-1])
            for mod in (integrator, ways):
                monkeypatch.setattr(mod, "gather_materials", gather64 if f64 else gather32)
            step = make_sharded_train_step(scene, params, way=w, fused="off", device="cpu")
            step(TrainState(scene.materials, camera, 0), rt.base_key(7), px, py, target)
            monkeypatch.setattr(train, "_grads", grads_of)
            grads[w, f64] = [g.double() for g in got[0]]

    def rel(a, b):
        return [float((x - y).norm() / max(float(y.norm()), 1e-30))
                for x, y in zip(grads[a], grads[b])]

    assert any(float(g.norm()) > 0 for g in grads["dod", True])
    assert max(rel((way, True), ("dod", True))) <= 1e-6
    for r, a, b in zip(rel((way, False), ("dod", False)), rel(("dod", False), ("dod", True)),
                       rel((way, False), (way, True))):
        assert r <= 1e-6 + a + b


def test_raw_to_png_matches_jax_tool(tmp_path, capsys):
    """Two port-CLI ``--way oo --raw`` runs merged by the port's raw_to_png
    and by the JAX package's: the same lines and the same PNG bytes."""
    from pt_three_ways_tpu import raw_to_png as raw_to_png_j

    raws = []
    for seed in (1, 2):
        raws.append(str(tmp_path / f"s{seed}.raw"))
        assert cli_main(["-w", "8", "-h", "6", "--spp", "2", "--seed", str(seed), "--way",
                         "oo", "--first-bounce-u", "2", "--first-bounce-v", "2",
                         "--save-every", "0", "--raw", "--device", "cpu", raws[-1]]) == 0
    capsys.readouterr()
    out_t, out_j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert raw_to_png.main([out_t, *raws]) == 0
    lines_t = capsys.readouterr().out.replace(out_t, "OUT")
    assert raw_to_png_j.main([out_j, *raws]) == 0
    lines_j = capsys.readouterr().out.replace(out_j, "OUT")
    assert lines_t == lines_j
    assert "Average spp: 4.00" in lines_t
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(out_t) > 0
