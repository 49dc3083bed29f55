"""The port's scene builder, catalog, packed tables and camera against the
JAX package's. Tolerance: none for the scene arrays and packed tables
(both builders do the same float64 host math and round once to float32);
camera rays allclose at 1e-6 (the port's CPU rounding follows XLA's
compiled code, the eager JAX call here does not contract multiply-adds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.camera import generate_rays as rays_j
from pt_three_ways_tpu.ops.pallas_intersect import PackedScene as PSj
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.models.catalog import create_scene as create_t
from pt_three_ways_tpu_torch.models.scene import SceneBuilder as SBt
from pt_three_ways_tpu_torch.models.scene import auto_epsilon, from_jax_arrays
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.ops.camera import generate_rays as rays_t
from pt_three_ways_tpu_torch.ops.intersect_kernel import PackedScene as PSt
from pt_three_ways_tpu_torch.ops.megakernel import PackedSceneFused
from pt_three_ways_tpu_torch.utils.render_params import RenderParams as RPt

SCENES = ["cornell", "suzanne", "ce", "single-sphere", "multi-sphere",
          "example1", "bbc-owl", "suzanne-sub1"]


def _build(name, w=24, h=20):
    bj = SBj()
    cam_j = create_j(bj, name, RPj(width=w, height=h))
    bt = SBt()
    cam_t = create_t(bt, name, RPt(width=w, height=h))
    return bj.build(), cam_j, bt.build(), cam_t


def jax_arrays(scene, camera) -> dict:
    d = {}
    for grp in ("spheres", "triangles", "materials"):
        part = getattr(scene, grp)
        for f in part._fields:
            d[f"{grp}.{f}"] = np.asarray(getattr(part, f))
    d["environment"] = np.asarray(scene.environment)
    for f in camera._fields:
        d[f"camera.{f}"] = np.asarray(getattr(camera, f))
    return d


def _assert_same_scene(sj, st):
    for grp in ("spheres", "triangles", "materials"):
        pj, pt = getattr(sj, grp), getattr(st, grp)
        for f in pj._fields:
            a = np.asarray(getattr(pj, f))
            b = getattr(pt, f).numpy()
            assert a.shape == b.shape, (grp, f)
            np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=f"{grp}.{f}")
    np.testing.assert_array_equal(np.asarray(sj.environment), st.environment.numpy())


@pytest.mark.parametrize("name", SCENES)
def test_scene_arrays_and_packed_tables_equal(name):
    sj, cam_j, st, cam_t = _build(name)
    _assert_same_scene(sj, st)
    for f in cam_j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(cam_j, f)),
                                      getattr(cam_t, f).numpy(), err_msg=f)
    pj, pt = PSj(sj), PSt(st)
    assert (pj.n_tri, pj.n_sph) == (pt.n_tri, pt.n_sph)
    for f in ("tri_tab", "sph_tab"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pt, f).numpy(), err_msg=f)
    # the port culls by 64-row window boxes: the JAX package's chunk boxes
    # (one a 64-row chunk, or one for a scene of at most 64 rows) widened by
    # the pack's margin
    if pt.n_tri:
        box_j = torch.tensor(np.asarray(pj.box_tab))
        np.testing.assert_array_equal(pt.wbox[:, 0:3].numpy(),
                                      (box_j[:, 0:3] - pt.wbox_margin).numpy())
        np.testing.assert_array_equal(pt.wbox[:, 3:6].numpy(),
                                      (box_j[:, 3:6] + pt.wbox_margin).numpy())


def test_from_jax_arrays_same_scene_and_attribute_rows():
    sj, cam_j, st, cam_t = _build("cornell")
    s2, c2 = from_jax_arrays(jax_arrays(sj, cam_j))
    _assert_same_scene(sj, s2)
    for f in cam_j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(cam_j, f)), getattr(c2, f).numpy())
    assert auto_epsilon(s2, c2) == auto_epsilon(st, cam_t)
    # megakernel attribute rows: the JAX tri_coef/sph_coef column order
    from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj

    pf_j, pf_t = PFj(sj), PackedSceneFused(s2)
    hi, mid, lo = (np.asarray(x, np.float32) for x in pf_j.tri_coef)
    coef = (hi + mid + lo)[:30, : pf_t.n_tri].T
    np.testing.assert_array_equal(coef, pf_t.tri_attr.numpy())
    hi, mid, lo = (np.asarray(x, np.float32) for x in pf_j.sph_coef)
    np.testing.assert_array_equal((hi + mid + lo)[:12, : pf_t.n_sph].T, pf_t.sph_attr.numpy())
    assert pf_j.no_glossy == pf_t.no_glossy
    with pytest.raises(KeyError):
        from_jax_arrays({})


@pytest.mark.parametrize("name", ["cornell", "single-sphere", "bbc-owl"])
def test_camera_rays_allclose(name):
    w, h = 24, 20
    sj, cam_j, st, cam_t = _build(name, w, h)
    n = w * h
    px = np.arange(n, dtype=np.int32) % w
    py = np.arange(n, dtype=np.int32) // w
    kj = rj.stream_key(rj.pass_key(rj.base_key(3), 1), rj.CAMERA_STREAM)
    kt = rt.stream_key(rt.pass_key(rt.base_key(3), 1), rt.CAMERA_STREAM)
    uj = rj.uniforms(kj, (4, n), jnp.float32)
    ut = rt.uniforms(kt, (4, n))
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    oj, dj = rays_j(cam_j, jnp.asarray(px), jnp.asarray(py), uj)
    ot, dt = rays_t(cam_t, torch.from_numpy(px), torch.from_numpy(py), ut)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
