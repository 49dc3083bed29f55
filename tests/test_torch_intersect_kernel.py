"""Kernel K2's plain version (ops/intersect_kernel.intersect_plain, the CPU
path of ``intersect_packed``) against the JAX package's Pallas kernel in
interpret mode and against its XLA ``intersect_scene``: on cornell (one
chunk), suzanne and suzanne-sub1 (the culled searches on the card), and on
suzanne with a sphere centred on a vertex of the mesh (spheres and
triangles competing for the same rays, the sphere winning an exact tie).

K2's pack (``PackedScene``): its window boxes are the culling tables of
``PackedSceneStream(scene, 64, 16)``, and every triangle lies inside its
window's widened box and every window box inside its level-1 box.

Tolerances:
  * winner index equal on >= 99.9 % of lanes; a lane that differs must be a
    near-tie (both winners' distances within 1e-4 relative);
  * ``t`` where the index agrees: rtol 1e-5 against the XLA path (an exact
    divide there, an exact divide plus one Newton step here); rtol 2e-5
    against the interpret-mode kernel, whose ``pl.reciprocal(approx=True)``
    starts the Newton step from a bfloat16 reciprocal, leaving a relative
    error of about (2^-8)^2 = 1.5e-5; plus atol 1e-6 (scene units are ~1)
    for the short distances, whose ``o_w`` already cancels digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.materials import MaterialSpec as MSj
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops.intersect import intersect_scene as scene_j
from pt_three_ways_tpu.ops.pallas_intersect import PackedScene as PSj
from pt_three_ways_tpu.ops.pallas_intersect import intersect_packed as packed_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.models.catalog import create_scene as create_t
from pt_three_ways_tpu_torch.models.materials import MaterialSpec as MSt
from pt_three_ways_tpu_torch.models.scene import SceneBuilder as SBt
from pt_three_ways_tpu_torch.ops import intersect_kernel as ik
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.utils.render_params import RenderParams as RPt


def _rays(camera, rng_np, n):
    """Half camera-like rays from the eye, half scattered rays from random
    points around the scene (bounce-like)."""
    eye = np.asarray(camera.centre, np.float32)
    axis = np.asarray(camera.axis_z, np.float32)
    d = axis[:, None] + 0.35 * rng_np.normal(size=(3, n))
    org = np.repeat(eye[:, None], n, axis=1) + 0.01 * rng_np.normal(size=(3, n))
    half = n // 2
    org[:, half:] = eye[:, None] + axis[:, None] * 2.5 + rng_np.normal(size=(3, n - half))
    d[:, half:] = rng_np.normal(size=(3, n - half))
    d /= np.linalg.norm(d, axis=0)
    live = rng_np.random(n) > 0.05
    return org.astype(np.float32), d.astype(np.float32), live


# an exact tie: the ray from (10, 10, 10) along +z meets the triangle (plane
# z = 12 as Woop rows of powers of two) and the sphere (centre (10, 10, 13),
# radius 1) at t = 2 exactly in float32 arithmetic
TIE_ORG, TIE_DIR = (10.0, 10.0, 10.0), (0.0, 0.0, 1.0)


def _scenes(name):
    """(JAX scene, port scene, JAX camera) of a catalog scene; ``+spheres``
    adds a sphere of radius 0.2 centred on a vertex of the mesh and, away
    from it, the exact tie of ``TIE_ORG`` (the same in both builders)."""
    base, _, extra = name.partition("+")
    bj, bt = SBj(), SBt()
    cam = create_j(bj, base, RPj(width=16, height=16))
    create_t(bt, base, RPt(width=16, height=16))
    if extra == "spheres":
        verts = bt.build().triangles.verts
        on_mesh = verts[verts.shape[0] // 2, 0].double().numpy()
        for b, ms in ((bj, MSj), (bt, MSt)):
            grey = ms.make_diffuse((0.5, 0.5, 0.5))
            b.add_sphere(on_mesh, 0.2, grey)
            b.add_triangle((9.0, 9.0, 12.0), (13.0, 9.0, 12.0), (9.0, 13.0, 12.0), grey)
            b.add_sphere((10.0, 10.0, 13.0), 1.0, grey)
    return bj.build(), bt.build(), cam


@pytest.mark.parametrize("name,cull", [("cornell", False), ("suzanne", True),
                                       ("suzanne-sub1", True), ("suzanne-sub1+spheres", True)])
def test_k2_plain_matches_jax(name, cull, rng_np):
    sj, st, cam = _scenes(name)
    pj, pt = PSj(sj), ik.PackedScene(st)
    assert (pt.n_tri > ik.TC) == cull  # the card's culled warp search, not the one-chunk scan
    n = 1024
    org, d, live = _rays(cam, rng_np, n)
    org[:, 0], d[:, 0], live[0] = TIE_ORG, TIE_DIR, True
    eps = 1e-4

    t_k, i_k = ik.intersect_packed(pt, torch.from_numpy(org), torch.from_numpy(d), eps,
                                   live=torch.from_numpy(live))
    t_k, i_k = t_k.numpy(), i_k.numpy()
    assert ik.intersect_packed.launches == 0  # CPU tensors never launch

    t_j, i_j = packed_j(pj, jnp.asarray(org), jnp.asarray(d), eps, interpret=True,
                        live=jnp.asarray(live))
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    hits = scene_j(sj, jnp.asarray(org), jnp.asarray(d), eps, live=jnp.asarray(live))
    t_x = np.asarray(hits.t)

    assert np.isfinite(t_k[live]).mean() > 0.3
    assert np.all(np.isinf(t_k[~live]))
    agree = i_k == i_j
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(t_k[~agree], t_j[~agree], rtol=1e-4)  # near-ties
    m = agree & np.isfinite(t_j)
    np.testing.assert_allclose(t_k[m], t_j[m], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(t_k), np.isfinite(t_j))
    # XLA path: same hit set, distances at rtol 1e-5
    np.testing.assert_array_equal(np.isfinite(t_k), np.isfinite(t_x))
    m = np.isfinite(t_x)
    np.testing.assert_allclose(t_k[m], t_x[m], rtol=1e-5, atol=1e-6)
    if name.endswith("+spheres"):
        # the sphere on the mesh takes rays from it; the exact tie goes to
        # the sphere (spheres seed best_t, a triangle must be strictly
        # nearer), as in the JAX package
        on_mesh = i_k == pt.n_tri + pt.n_sph - 2
        assert on_mesh.sum() > 0 and (np.isfinite(t_k) & (i_k < pt.n_tri)).sum() > 100
        tie_tri = ik.chunk_min_plain(pt.tri_tab[pt.n_tri - 1:pt.n_tri], pt.n_tri - 1,
                                     torch.tensor(TIE_ORG)[:, None],
                                     torch.tensor(TIE_DIR)[:, None], eps, False)
        assert tie_tri[0].item() == 2.0 and tie_tri[1].item() == pt.n_tri - 1
        assert (t_k[0], i_k[0]) == (2.0, pt.n_tri + pt.n_sph - 1) == (t_j[0], i_j[0])


@pytest.mark.parametrize("name", ["cornell", "suzanne", "suzanne-sub1"])
def test_k2_pack_window_boxes(name):
    """K2's culling tables are PackedSceneStream(scene, 64, 16)'s, built with
    the pack; each triangle lies inside its window's widened box, each
    window box inside its level-1 box."""
    _, st, _ = _scenes(name)
    pt, ps = ik.PackedScene(st), mk.PackedSceneStream(st, 64, 16)
    assert (pt.window, pt.fan, pt.n_windows, pt.n_groups) == (64, 16, ps.n_windows,
                                                              ps.n_groups)
    assert pt.wbox_margin == ps.wbox_margin > 0.0
    for f in ("wbox", "wbox1"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), getattr(ps, f).numpy(), f)
    n = st.num_triangles
    assert pt.n_windows == -(-n // 64) and pt.n_groups == -(-pt.n_windows // 16)
    verts = st.triangles.verts.to(torch.float32)
    box = pt.wbox[torch.arange(n) // 64]
    assert (verts >= box[:, None, 0:3]).all() and (verts <= box[:, None, 3:6]).all()
    # the widening is strict: no vertex on a face of its box
    assert (verts > box[:, None, 0:3]).all() and (verts < box[:, None, 3:6]).all()
    grp = pt.wbox1[torch.arange(pt.n_windows) // 16]
    assert (pt.wbox[:, 0:3] >= grp[:, 0:3]).all() and (pt.wbox[:, 3:6] <= grp[:, 3:6]).all()


def test_k2_wrapper_checks_shapes():
    bt = SBt()
    create_t(bt, "single-sphere", RPt(width=8, height=8))
    pt = ik.PackedScene(bt.build())
    with pytest.raises(ValueError):
        ik.intersect_packed(pt, torch.zeros(4, 8), torch.zeros(4, 8), 1e-4)

