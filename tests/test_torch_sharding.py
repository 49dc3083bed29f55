"""The port's multi-device rendering and training (``parallel/mesh``,
``parallel/shard``, ``parallel/train`` on a mesh) against the JAX
package's ``render_sharded`` and ``make_sharded_train_step``, on the CPU.

The JAX side runs on ``make_mesh(n_devices=k, dp=d)`` over the conftest's
virtual CPU devices. The port side runs once per module on four ``gloo``
ranks on 127.0.0.1 (``parallel/distributed.spawn``, one intra-op thread
each), which build every mesh below inside their world (dp x sp of (1, 4),
(2, 2), (4, 1), (1, 2), (2, 1), (1, 1)) and run every case; rank 0 returns
the results. Scenes are 16^2, as in the JAX package's tests/test_sharding.py.

  * The scan wavefront: sums per pixel within rtol/atol 1e-6 of JAX on
    (1, 4), (2, 2) and (4, 1), and bit-identical when run twice.
  * dp invariance at fixed sp with an spp (5) that is not a multiple of
    dp; the (2, 2) render against single-device passes under the keys
    fold(fold(base, sample), tile*sp + q); resume bit-identical; the pass
    fn returning the dp sum (within 1e-6 of JAX's).
  * The regenerating megakernel (``intersector="kernel"``: its plain
    version on the CPU): table-mode rounds within 3e-4 of ``fused="off"``
    and, by 4x4 block means (rtol 2e-2, atol 2e-3, as
    tests/test_torch_render.py holds the kernel path), of JAX's
    pallas-interpret sharded render; dp invariance within 1e-6; the
    remainder round with exact spp; the feedback sort bit-exact; classic
    blocks equal to single-pass launches; the autotune flow deterministic
    with exact spp (also with a pinned group size); the stream tier equal
    to the resident one with its gate lowered.
  * Train steps on (2, 1), (1, 2) and (2, 2), ``fused="off"`` and the
    regenerating replay path: the loss within rtol 1e-5 and each material
    update within tests/test_torch_train.py's tolerances of JAX's (1e-4 of
    the field's largest update, 1e-3 for the ior), but never finer than
    two float32 spacings of the updated value: this scene's ior gradient
    (a Fresnel material at ior 1) is rounding noise whose update is below
    one spacing of 1.0, so either side rounds it to 0 or +-1 ulp; the loss
    falling over 5 ``remat`` steps at dp=2.
  * A 1-rank mesh: its render equal to ``render()``, and its train steps
    (replay and regenerating) equal to ``mesh=None``, bit for bit.
"""

import multiprocessing

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.materials import MaterialSpec
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.ops.camera import make_camera
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

if multiprocessing.parent_process() is None:  # not in the spawned ranks
    from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

MESHES = ((1, 4), (2, 2), (4, 1), (1, 2), (2, 1), (1, 1))
TRAIN_MESHES = ((2, 1), (1, 2), (2, 2))
REGEN_S = 2
LR = 0.05


def assert_updates_close(new, new_j, old, names):
    """tests/test_torch_train.py's gate on (new - old), floored at two
    float32 spacings of the value (an update below it is not resolved)."""
    for a, b, o, name in zip(new, new_j, old, names):
        b, o = np.asarray(b), np.asarray(o)
        assert np.isfinite(a).all(), name
        tol = 1e-3 if name == "ior" else 1e-4
        scale = max(np.abs(b - o).max(), 1e-6)
        atol = np.maximum(tol * scale, 2 * np.spacing(np.abs(o).astype(np.float32)))
        assert (np.abs((a - o) - (b - o)) <= atol).all(), (name, a - o, b - o)


def build(width=16, height=16):
    """The port's twin of the JAX package's tests/test_sharding.build."""
    sb = SceneBuilder()
    sb.add_sphere((0, 0, 5), 1.5, MaterialSpec.make_diffuse((0.6, 0.4, 0.3)))
    sb.add_sphere((1.5, 1.5, 4), 0.8, MaterialSpec.make_light((4, 4, 4)))
    sb.set_environment_colour((0.1, 0.1, 0.1))
    params = RenderParams(
        width=width, height=height, samples_per_pixel=4,
        first_bounce_u_samples=2, first_bounce_v_samples=2, max_depth=3, seed=9,
    )
    camera = make_camera((0, 0, 0), (0, 0, 5), (0, 1, 0), width, height, 60.0)
    return sb.build(), camera, params


def cornell(**kw):
    params = RenderParams(width=16, height=16, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=3, seed=9, **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    return sb.build(), camera, params


def pixels(n=256, width=16):
    return np.arange(n, dtype=np.int32) % width, np.arange(n, dtype=np.int32) // width


def target(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)


def _rank_cases(tmp):
    """Every port-side case on this rank (rank 0's results are returned)."""
    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.ops import megakernel
    from pt_three_ways_tpu_torch.parallel.mesh import all_gather, make_mesh
    from pt_three_ways_tpu_torch.parallel.shard import make_sharded_pass_fn, render_sharded
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    torch.set_num_threads(1)
    meshes = {m: make_mesh(n_devices=m[0] * m[1], dp=m[0], device="cpu") for m in MESHES}
    res = {}

    def rs(name, mesh, scene, camera, params, **kw):
        out = render_sharded(scene, camera, params, meshes[mesh], **kw)
        if out is not None:
            res[name] = (out.sum.copy(), out.count.copy())

    scene, camera, params = build()
    for m in ((1, 4), (2, 2), (4, 1)):
        rs(f"scan{m}", m, scene, camera, params)
        rs(f"scan{m} again", m, scene, camera, params)
    p5 = params.replace(samples_per_pixel=5)
    rs("spp5 (1, 2)", (1, 2), scene, camera, p5)
    rs("spp5 (2, 2)", (2, 2), scene, camera, p5)
    rank = meshes[(4, 1)].rank
    ckpt = f"{tmp}/part{rank}.raw"
    part = render_sharded(scene, camera, params.replace(samples_per_pixel=2), meshes[(2, 2)])
    if part is not None:
        part.save(ckpt)
    rs("resumed", (2, 2), scene, camera, params, resume_from=ckpt)

    mesh = meshes[(2, 2)]
    if mesh.member:
        fn = make_sharded_pass_fn(scene, camera, params, mesh)
        px, py = (torch.from_numpy(a).reshape(2, -1)[mesh.sp_idx] for a in pixels())
        rad = fn(rt.base_key(params.seed), 0, 0, px, py)
        res["pass fn"] = all_gather(rad, mesh.sp_group).numpy()

    regen = params.replace(intersector="kernel", passes_per_dispatch=2, rng_mode="table")
    rs("regen table", (2, 2), scene, camera, regen)
    rs("classic", (2, 2), scene, camera, params.replace(intersector="kernel", fused="off"))
    krng = params.replace(intersector="kernel", passes_per_dispatch=2)
    rs("regen (1, 2)", (1, 2), scene, camera, krng)
    rs("regen (2, 2)", (2, 2), scene, camera, krng)
    rs("regen spp5", (2, 2), scene, camera, krng.replace(samples_per_pixel=5))
    rs("regen sorted", (2, 2), scene, camera, krng.replace(regen_feedback_sort=True))
    rs("blocks", (2, 2), scene, camera, params.replace(passes_per_dispatch=2))

    for ppd in (0, 3):
        c_scene, c_camera, c_params = cornell(samples_per_pixel=12, intersector="kernel",
                                              passes_per_dispatch=ppd)
        rs(f"autotune ppd{ppd}", (2, 2), c_scene, c_camera, c_params)
        rs(f"autotune ppd{ppd} again", (2, 2), c_scene, c_camera, c_params)
    c_scene, c_camera, c_params = cornell(samples_per_pixel=6, intersector="kernel",
                                          passes_per_dispatch=3, rng_mode="kernel")
    rs("resident", (2, 2), c_scene, c_camera, c_params)
    fits = megakernel.scene_fits_resident
    megakernel.scene_fits_resident = lambda s: False
    try:
        rs("streamed", (2, 2), c_scene, c_camera, c_params)
    finally:
        megakernel.scene_fits_resident = fits

    # training: fused="off" (the scan wavefront's autograd) and the
    # regenerating replay path, one step each on every mesh
    px, py = (torch.from_numpy(a) for a in pixels())
    tgt = torch.from_numpy(target(256, 5))
    state = TrainState(scene.materials, camera, 0)
    for m in TRAIN_MESHES:
        if not meshes[m].member:
            continue
        for tag, kw in (("off", dict(fused="off")),
                        ("regen", dict(passes_per_step=REGEN_S))):
            p = params.replace(intersector="kernel") if tag == "regen" else params
            step = make_sharded_train_step(scene, p, meshes[m], learning_rate=LR, **kw)
            loss, new = step(state, rt.base_key(3), px, py, tgt)
            res[f"train {tag} {m}"] = (float(loss), [x.numpy() for x in new.materials])
    if meshes[(2, 1)].member:
        step = make_sharded_train_step(scene, params.replace(remat=True), meshes[(2, 1)],
                                       learning_rate=LR)
        st, losses = state, []
        for i in range(5):
            loss, st = step(st, rt.fold_in(rt.base_key(11), i), px, py, torch.zeros(256, 3))
            losses.append(float(loss))
        res["remat losses"] = losses
        # the loss of the first and the trained materials on the same samples
        res["remat eval"] = [float(step(s, rt.base_key(12), px, py, torch.zeros(256, 3))[0])
                             for s in (state, st)]

    one = meshes[(1, 1)]
    if one.member:
        rs("one rank", (1, 1), scene, camera, krng)
        out = render(scene, camera, krng, device="cpu")
        res["render"] = (out.sum, out.count)
        kp = params.replace(intersector="kernel")
        for tag, kw in (("replay", {}), ("regen", dict(passes_per_step=REGEN_S))):
            for mesh in (one, None):
                step = make_sharded_train_step(scene, kp, mesh, learning_rate=LR,
                                               device="cpu", **kw)
                st = state
                for seed in (3, 4):
                    loss, st = step(st, rt.base_key(seed), px, py, tgt)
                res[f"one rank train {tag} {mesh is None}"] = (
                    float(loss), [x.numpy() for x in st.materials])
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from pt_three_ways_tpu_torch.parallel import distributed

    tmp = str(tmp_path_factory.mktemp("ranks"))
    return distributed.spawn(_rank_cases, 4, tmp, device="cpu", threads=1, timeout=600)


def jax_build(width=16, height=16):
    from test_sharding import build as build_j

    return build_j(width, height)


def jax_render(mesh_shape, params_fn=lambda p: p, scene=None):
    from pt_three_ways_tpu.parallel.mesh import make_mesh as mesh_j
    from pt_three_ways_tpu.parallel.shard import render_sharded as render_j

    sj, cam_j, pj = scene or jax_build()
    dp, sp = mesh_shape
    return render_j(sj, cam_j, params_fn(pj), mesh_j(n_devices=dp * sp, dp=dp))


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2), (4, 1)], ids=str)
def test_scan_wavefront_matches_jax_and_is_deterministic(port, mesh):
    s, c = port[f"scan{mesh}"]
    s2, c2 = port[f"scan{mesh} again"]
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(c, c2)
    ref = jax_render(mesh)
    np.testing.assert_allclose(s, ref.sum, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(c, ref.count)
    assert (c == 4).all()


def test_dp_count_is_bit_invariant_at_fixed_sp(port):
    (a, ca), (b, cb) = port["spp5 (1, 2)"], port["spp5 (2, 2)"]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (ca == 5).all() and (cb == 5).all()


def test_sharded_render_matches_single_device_passes_per_pixel(port):
    """The (2, 2) sum equals the single-device passes under the keys
    fold(fold(base, sample), tile*sp + q), shard q of the pixels each."""
    from pt_three_ways_tpu_torch.models.ways import WAYS

    scene, camera, params = build()
    px, py = (torch.from_numpy(a) for a in pixels())
    base = rt.base_key(params.seed)
    sp, block = 2, 128
    expect = np.zeros((256, 3), np.float64)
    for sample in range(params.samples_per_pixel):
        for q in range(sp):
            key = rt.tile_key(rt.pass_key(base, sample), q)
            sl = slice(q * block, (q + 1) * block)
            expect[sl] += WAYS["dod"](scene, camera, params, key, px[sl], py[sl],
                                      1024).numpy()
    np.testing.assert_allclose(port["scan(2, 2)"][0].reshape(256, 3), expect,
                               rtol=1e-6, atol=1e-6)


def test_sharded_resume_is_bit_identical(port):
    np.testing.assert_array_equal(port["resumed"][0], port["scan(2, 2)"][0])
    np.testing.assert_array_equal(port["resumed"][1], port["scan(2, 2)"][1])


def test_sharded_pass_radiance_is_dp_sum(port):
    import jax.numpy as jnp
    from pt_three_ways_tpu.ops import rng as rj
    from pt_three_ways_tpu.parallel.mesh import make_mesh as mesh_j
    from pt_three_ways_tpu.parallel.shard import make_sharded_pass_fn as fn_j

    sj, cam_j, pj = jax_build()
    px, py = pixels()
    ref = np.asarray(fn_j(sj, cam_j, pj, mesh_j(n_devices=4, dp=2))(
        rj.base_key(pj.seed), 0, 0, jnp.asarray(px), jnp.asarray(py)))
    got = port["pass fn"]
    assert got.shape == (256, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    single = port["scan(4, 1)"][0].mean() / 4  # one pass of the same pixels
    assert 1.5 < got.mean() / single < 2.5


def test_sharded_regen_rounds_match_classic_and_jax(port):
    (regen, count), (classic, _) = port["regen table"], port["classic"]
    assert (count == 4).all()
    np.testing.assert_allclose(regen, classic, rtol=3e-4, atol=3e-4)
    ref = jax_render((2, 2), lambda p: p.replace(intersector="pallas-interpret",
                                                 passes_per_dispatch=2, rng_mode="table"))
    blocks = lambda a: (a / 4).reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(blocks(regen), blocks(ref.sum), rtol=2e-2, atol=2e-3)


def test_sharded_regen_dp_invariance(port):
    (a, ca), (b, cb) = port["regen (1, 2)"], port["regen (2, 2)"]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (ca == 4).all() and (cb == 4).all()


def test_sharded_regen_exact_spp_with_remainder(port):
    s, c = port["regen spp5"]
    assert (c == 5).all()
    assert np.isfinite(s).all()


def test_sharded_feedback_sort_is_bit_exact(port):
    np.testing.assert_array_equal(port["regen sorted"][0], port["regen (2, 2)"][0])
    np.testing.assert_array_equal(port["regen sorted"][1], port["regen (2, 2)"][1])


def test_sharded_classic_blocks_match_single_pass_dispatches(port):
    np.testing.assert_allclose(port["blocks"][0], port["scan(2, 2)"][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port["blocks"][1], port["scan(2, 2)"][1])


@pytest.mark.parametrize("ppd", [0, 3])
def test_sharded_autotune_probe_decide_rebuild(port, ppd):
    (a, ca), (b, cb) = port[f"autotune ppd{ppd}"], port[f"autotune ppd{ppd} again"]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert (ca == 12).all()
    assert np.isfinite(a).all()


def test_sharded_stream_tier_matches_resident(port):
    np.testing.assert_array_equal(port["streamed"][0], port["resident"][0])
    np.testing.assert_array_equal(port["streamed"][1], port["resident"][1])


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=str)
@pytest.mark.parametrize("tag", ["off", "regen"])
def test_train_step_matches_jax(port, mesh, tag):
    import jax.numpy as jnp
    from pt_three_ways_tpu.ops import rng as rj
    from pt_three_ways_tpu.parallel.mesh import make_mesh as mesh_j
    from pt_three_ways_tpu.parallel.train import TrainState as TSj
    from pt_three_ways_tpu.parallel.train import make_sharded_train_step as step_j

    sj, cam_j, pj = jax_build()
    if tag == "regen":
        pj = pj.replace(intersector="pallas-interpret")
        kw = dict(passes_per_step=REGEN_S)
    else:
        kw = dict(fused="off")
    step = step_j(sj, pj, mesh_j(n_devices=mesh[0] * mesh[1], dp=mesh[0]),
                  learning_rate=LR, **kw)
    px, py = pixels()
    loss_j, new_j = step(TSj(sj.materials, cam_j, jnp.int32(0)), rj.base_key(3),
                         jnp.asarray(px), jnp.asarray(py), jnp.asarray(target(256, 5)))
    loss, mats = port[f"train {tag} {mesh}"]
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    assert_updates_close(mats, new_j.materials, sj.materials, new_j.materials._fields)


def test_train_step_decreases_loss(port):
    """Five remat steps at dp=2: each step's loss (its own samples) within
    rtol 1e-5 of JAX's on the same mesh, and on one fixed set of samples
    the trained materials' loss below the first materials'."""
    import jax
    import jax.numpy as jnp
    from pt_three_ways_tpu.ops import rng as rj
    from pt_three_ways_tpu.parallel.mesh import make_mesh as mesh_j
    from pt_three_ways_tpu.parallel.train import TrainState as TSj
    from pt_three_ways_tpu.parallel.train import make_sharded_train_step as step_j

    sj, cam_j, pj = jax_build()
    step = step_j(sj, pj.replace(remat=True), mesh_j(n_devices=2, dp=2), learning_rate=LR)
    px, py = (jnp.asarray(a) for a in pixels())
    state, ref = TSj(sj.materials, cam_j, jnp.int32(0)), []
    for i in range(5):
        loss, state = step(state, jax.random.fold_in(rj.base_key(11), i), px, py,
                           jnp.zeros((256, 3), jnp.float32))
        ref.append(float(loss))
    losses = port["remat losses"]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    first, trained = port["remat eval"]
    assert trained < first


def test_one_rank_mesh_equals_one_device(port):
    np.testing.assert_array_equal(port["one rank"][0], port["render"][0])
    np.testing.assert_array_equal(port["one rank"][1], port["render"][1])
    for tag in ("replay", "regen"):
        loss, mats = port[f"one rank train {tag} False"]
        loss1, mats1 = port[f"one rank train {tag} True"]
        assert loss == loss1
        for a, b in zip(mats, mats1):
            np.testing.assert_array_equal(a, b)


def test_mesh_shape_and_rank_layout():
    from pt_three_ways_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.size == 1
    assert (mesh.dp_idx, mesh.sp_idx) == (0, 0) and mesh.group is None
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(dp=2, device="cpu")
    with pytest.raises(ValueError, match="world has 1"):
        make_mesh(n_devices=2, device="cpu")
