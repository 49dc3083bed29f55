"""float64 on the CPU and ``remat`` in the port, against the JAX package
(whose gradient tests run in float64, tests/test_gradients.py).

  * ``ops/rng.uniforms(..., torch.float64)`` equals ``jax.random.uniform``
    float64 bit for bit (tolerance: none);
  * the float64 ``trace_pass`` on tests/test_gradients.py's scene, and the
    ``oo`` way, against the jitted JAX function: within 1e-12
    (the port contracts float64 products into sums as XLA does; XLA's
    float64 ``1/sqrt`` and transcendental functions may differ from the
    port's in the last bit, ops/xla_cpu.py);
  * material gradients from ``torch.autograd`` against ``jax.grad`` (rtol
    1e-9); ``remat=True`` against ``remat=False`` (rtol 1e-10, the
    counterpart of tests/test_gradients.py:79); one central finite
    difference (rel 2e-3, as tests/test_gradients.py:45);
  * ``cli --dtype float64 --device cpu`` renders; with ``--device cuda``
    it exits 1 before touching a device, and ``render`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models import ways as ways_j
from pt_three_ways_tpu.models.materials import MaterialSpec as MSj
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.camera import make_camera as camera_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.cli import main as cli_main
from pt_three_ways_tpu_torch.models import ways
from pt_three_ways_tpu_torch.models.materials import MaterialSpec, MaterialTable
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.ops.camera import make_camera
from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput
from pt_three_ways_tpu_torch.utils.render_params import RenderParams
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(width=8, height=8, first_bounce_u_samples=2, first_bounce_v_samples=2,
          max_depth=4, seed=5)
FIELDS = ("diffuse", "emission")


@pytest.mark.parametrize("seed", [0, 11, 2**32 + 7])
def test_float64_uniforms_bit_equal(seed):
    for fold in (0, rj.CAMERA_STREAM, rj.BOUNCE_STREAM_BASE + 3):
        kj = jax.random.fold_in(rj.base_key(seed), fold)
        kt = rt.fold_in(rt.base_key(seed), fold)
        for shape in [(1,), (7,), (4, 33), (3, 17, 4), (2, 1000)]:
            a = np.asarray(jax.random.uniform(kj, shape, jnp.float64))
            b = rt.uniforms(kt, shape, "cpu", torch.float64).numpy()
            assert b.dtype == np.float64 and b.shape == a.shape
            np.testing.assert_array_equal(b.view(np.int64), a.view(np.int64))
            assert (b >= 0).all() and (b < 1).all()


def _build(sb, ms, dtype, cam):
    """tests/test_gradients.py's build() scene."""
    sb.add_sphere((0, 0, 5), 1.5, ms.make_diffuse((0.6, 0.4, 0.3)))
    sb.add_sphere((2.5, 2.5, 3), 1.0, ms.make_light((4, 4, 4)))
    sb.add_triangle((-8, -3, 9), (8, -3, 9), (0, -3, -9), ms.make_diffuse((0.5, 0.5, 0.5)))
    sb.set_environment_colour((0.1, 0.12, 0.15))
    return sb.build(dtype), cam((0, 0, 0), (0, 0, 5), (0, 1, 0), 8, 8, 60.0, dtype)


def _grid():
    return np.arange(64, dtype=np.int32) % 8, np.arange(64, dtype=np.int32) // 8


def _port(way="dod", **kw):
    scene, camera = _build(SceneBuilder(), MaterialSpec, torch.float64, make_camera)
    xs, ys = (torch.from_numpy(a) for a in _grid())
    key = rt.pass_key(rt.base_key(KW["seed"]), 0)
    params = RenderParams(**KW, **kw)

    def image_sum(mats):
        return ways.WAYS[way](scene._replace(materials=mats), camera, params, key, xs,
                              ys).sum()

    return scene, image_sum


def _jax(way="dod"):
    scene, camera = _build(SBj(), MSj, jnp.float64, camera_j)
    xs, ys = (jnp.asarray(a) for a in _grid())
    key = rj.pass_key(rj.base_key(KW["seed"]), 0)
    params = RPj(**KW)

    def image(mats):
        return ways_j.WAYS[way](scene._replace(materials=mats), camera, params, key, xs, ys)

    return scene, image


def _leaves(scene):
    return [m.clone().requires_grad_() for m in scene.materials]


@pytest.mark.parametrize("way", ["dod", "oo"])
def test_float64_pass_matches_jax(way):
    sj, image_j = _jax(way)
    ref = np.asarray(jax.jit(image_j)(sj.materials))
    scene, camera = _build(SceneBuilder(), MaterialSpec, torch.float64, make_camera)
    xs, ys = (torch.from_numpy(a) for a in _grid())
    got = ways.WAYS[way](scene, camera, RenderParams(**KW),
                         rt.pass_key(rt.base_key(KW["seed"]), 0), xs, ys)
    assert got.dtype == torch.float64 and got.shape == (64, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert ref.mean() > 0.01


def test_material_gradients_match_jax():
    sj, image_j = _jax()
    g_j = jax.jit(jax.grad(lambda m: jnp.sum(image_j(m))))(sj.materials)
    scene, image_sum = _port()
    mats = _leaves(scene)
    grads = torch.autograd.grad(image_sum(MaterialTable(*mats)), mats, allow_unused=True)
    for name, g, gj in zip(MaterialTable._fields, grads, g_j):
        gj = np.asarray(gj)
        g = np.zeros_like(gj) if g is None else g.numpy()
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, gj, rtol=1e-9, atol=1e-12, err_msg=name)
    assert np.abs(np.asarray(g_j.diffuse)).sum() > 0


def test_remat_matches_exact_gradient():
    g = []
    for remat in (False, True):
        scene, image_sum = _port(remat=remat)
        mats = _leaves(scene)
        g.append(torch.autograd.grad(image_sum(MaterialTable(*mats)), mats,
                                     allow_unused=True))
    for name, a, b in zip(MaterialTable._fields, *g):
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("field", FIELDS)
def test_finite_difference(field):
    scene, image_sum = _port()
    mats = _leaves(scene)
    i = MaterialTable._fields.index(field)
    g = torch.autograd.grad(image_sum(MaterialTable(*mats)), mats[i])[0].numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    h = 1e-5
    checked = 0
    for idx in np.ndindex(g.shape):
        if abs(g[idx]) < 1e-6:
            continue
        vals = []
        for sgn in (1, -1):
            pert = [m.detach().clone() for m in scene.materials]
            pert[i][idx] += sgn * h
            vals.append(float(image_sum(MaterialTable(*pert))))
        fd = (vals[0] - vals[1]) / (2 * h)
        assert fd == pytest.approx(float(g[idx]), rel=2e-3, abs=1e-6)
        checked += 1
        if checked >= 3:
            break
    assert checked >= 1


def test_cli_float64(tmp_path):
    raw = str(tmp_path / "f64.raw")
    assert cli_main(["-w", "8", "-h", "6", "--spp", "2", "--seed", "3", "--dtype", "float64",
                     "--save-every", "0", "--raw", "--device", "cpu", raw]) == 0
    out = ArrayOutput.load(raw)
    assert out.total_samples() == 96 and np.isfinite(out.mean()).all()
    assert cli_main(["-w", "8", "-h", "6", "--spp", "1", "--dtype", "float64",
                     "--device", "cuda", str(tmp_path / "x.png")]) == 1
    scene, camera = _build(SceneBuilder(), MaterialSpec, torch.float64, make_camera)
    with pytest.raises(ValueError, match="CPU"):
        # a CUDA float64 render raises before it looks for a card
        render(scene, camera, RenderParams(dtype="float64", **KW), device="cuda")


@pytest.mark.parametrize("case", ["render-scene", "render-camera", "train-scene",
                                  "train-params"])
def test_float64_on_cuda_raises(case):
    """float64 anywhere in what a call computes with (the scene, the camera
    or params.dtype) raises on a CUDA device, with default params too, and
    before the call looks for a card: nothing is cast or moved quietly."""
    from pt_three_ways_tpu_torch.parallel.train import make_sharded_train_step

    s64, c64 = _build(SceneBuilder(), MaterialSpec, torch.float64, make_camera)
    s32, _ = _build(SceneBuilder(), MaterialSpec, torch.float32, make_camera)
    with pytest.raises(ValueError, match="CPU"):
        if case == "render-scene":
            render(s64, c64, RenderParams(**KW), device="cuda")
        elif case == "render-camera":
            render(s32, c64, RenderParams(**KW), device="cuda")
        elif case == "train-scene":
            make_sharded_train_step(s64, RenderParams(**KW), fused="off", device="cuda")
        else:
            make_sharded_train_step(s32, RenderParams(dtype="float64", **KW), device="cuda")
