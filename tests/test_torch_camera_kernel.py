"""The camera stage's dispatch to K13 and the slices it writes, on the CPU.

K13 (``ops/camera_kernel``, ``csrc/camera_stage.cu``) runs only on a card;
its bit-equality with the eager stage is ``tests/test_torch_cuda.py``'s.
Here, without a card:

  * ``integrator.uses_camera_kernel`` picks K13 only for a CUDA device, a
    float32 camera, the kernel backend and a stage that nothing
    differentiates (grad mode off, or no camera, geometry or material
    tensor requiring grad);
  * ``regen_front``'s state0 and base_sum, whose stages write their rows
    into slices of one state0 and add their bases in place, equal bit for
    bit the concatenation and the sum of separately called stages, on
    cornell, suzanne and bbc-owl tiles;
  * every C entry point of ``csrc/*.cu`` takes as many arguments as its
    ctypes signature in ``ops/_cuda._SIGNATURES`` lists;
  * the K13 wrappers refuse tensors that are not on a card.
"""

import glob
import os
import re
import sys

import pytest
import torch

from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
from pt_three_ways_tpu_torch.ops import _cuda, camera_kernel, rng
from pt_three_ways_tpu_torch.ops.megakernel import PackedSceneStream
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_megakernel import one_torch_thread  # noqa: E402, F401 (autouse fixture)


def _tile(name, w=16, h=12, dtype=torch.float32, **kw):
    params = RenderParams(width=w, height=h, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=3, seed=5, **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params, dtype)
    scene = sb.build(dtype=dtype)
    params = params.replace(epsilon=auto_epsilon(scene, camera))
    r = w * h - 5  # a ragged tile
    px = torch.arange(r, dtype=torch.int32) % w
    py = torch.arange(r, dtype=torch.int32) // w
    return scene, camera, params, px, py


def _requires_grad(tensor):
    return tensor.detach().clone().requires_grad_()


@pytest.mark.parametrize("case, expect", [
    ("cpu", False),
    ("float64", False),
    ("materials_require_grad", False),
    ("camera_requires_grad", False),
    ("grad_mode_off", True),
    ("cuda_float32", True),
])
def test_uses_camera_kernel(case, expect):
    dtype = torch.float64 if case == "float64" else torch.float32
    scene, camera, _, _, _ = _tile("cornell", dtype=dtype)
    device = "cpu" if case == "cpu" else "cuda"
    if case in ("materials_require_grad", "grad_mode_off"):
        scene = scene._replace(materials=type(scene.materials)(
            *(_requires_grad(m) for m in scene.materials)))
    if case == "camera_requires_grad":
        camera = camera._replace(centre=_requires_grad(camera.centre))
    with torch.set_grad_enabled(case != "grad_mode_off"):
        got = integ.uses_camera_kernel(scene, camera, "kernel", device)
    assert got is expect
    # the other backend never takes it
    with torch.no_grad():
        assert not integ.uses_camera_kernel(scene, camera, "xla", device)


@pytest.mark.parametrize("name", ["cornell", "suzanne", "bbc-owl"])
def test_regen_front_slices_match_separate_stages(name):
    scene, camera, params, px, py = _tile(name)
    packed = PackedSceneStream(scene)
    base_key = rng.base_key(2 ** 33 + 17)
    s_count, sample0, tile_idx = 3, 5, 1
    base_sum, state0, unif = integ.regen_front(scene, camera, params, base_key, sample0,
                                               tile_idx, px, py, s_count, 1024, packed,
                                               packed.no_glossy)
    assert unif is None
    rows, total = [], torch.zeros((3, px.shape[0]))
    for s in range(s_count):
        key = rng.fold_in(rng.fold_in(base_key, sample0 + s), tile_idx)
        st, base, _ = integ._first_bounce_state(scene, camera, params, key, px, py, 1024,
                                                "kernel", want_unif=False, packed=packed,
                                                no_glossy=packed.no_glossy)
        rows.append(st)
        total = total + base
    want = torch.cat(rows, dim=0)
    assert state0.shape == want.shape and state0.is_contiguous()
    assert torch.equal(state0.view(torch.int32), want.view(torch.int32))
    assert torch.equal(base_sum.view(torch.int32), total.view(torch.int32))
    assert float(state0[9::10].mean()) > 0.1  # rays hit the scene


def test_entry_points_match_ctypes_signatures():
    """An argument count off by one in ``_SIGNATURES`` shifts every later
    argument of a launch; the card would be the first to see it."""
    found = {}
    for src in glob.glob(os.path.join(_cuda.CSRC, "*.cu")):
        text = open(src).read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    assert set(found) == set(_cuda._SIGNATURES)
    for name, n_args in found.items():
        assert len(_cuda._SIGNATURES[name]) == n_args, name


def test_k13_wrappers_refuse_cpu_tensors():
    scene, camera, params, px, py = _tile("cornell")
    unif = torch.zeros((4, px.shape[0]))
    with pytest.raises(ValueError):
        camera_kernel.camera_rays(camera, px, py, unif)
    r, k = px.shape[0], params.first_bounce_samples
    rays = torch.zeros((3, r))
    with pytest.raises(ValueError):
        camera_kernel.first_bounce(PackedSceneStream(scene), rays, rays, torch.zeros(r),
                                   torch.zeros(r, dtype=torch.int32), torch.zeros((3, r, k)),
                                   2, torch.empty((10, r * k)), torch.empty((3, r)), False,
                                   False, True)
    assert camera_kernel.camera_rays.launches == 0
    assert camera_kernel.first_bounce.launches == 0
