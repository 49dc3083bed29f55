"""The plain reference agrees with the port's own CPU render and training
step at tiny sizes (the port's kernels' plain versions on the CPU, the
card's route and random streams)."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, core, inputs
from portbench.reference import render as ref_render
from portbench.reference import scene as ref_scene
from portbench.reference import train as ref_train
from portbench.reference.tracer import Geometry


def _config(name):
    return json.load(open(os.path.join(core.HERE, "configs", name + ".json")))


def _port_scene(name, params):
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon

    b = SceneBuilder()
    cam = create_scene(b, name, params)
    sc = b.build()
    return sc, cam, params.replace(epsilon=auto_epsilon(sc, cam))


@pytest.mark.parametrize("name,w,h,spp,rng_mode", [
    ("cornell", 24, 14, 2, "auto"), ("suzanne", 16, 16, 2, "auto"), ("cornell", 16, 16, 1, "table")])
def test_render_matches_port(name, w, h, spp, rng_mode):
    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    seed = 2 ** 33 + 12345
    params = RenderParams(width=w, height=h, samples_per_pixel=spp, seed=seed,
                          intersector="kernel", rng_mode=rng_mode)
    sc, cam, params = _port_scene(name, params)
    out = render(sc, cam, params, device="cpu")
    prog = (out.sum / out.count[..., None]).reshape(-1, 3)
    rs = ref_scene.build(_config(name), w, h)
    assert rs.epsilon == pytest.approx(params.epsilon, rel=1e-6)
    ys, xs = np.mgrid[0:h, 0:w]
    ref, _ = ref_render.pixel_means(rs, Geometry(rs, "cpu", torch.float64), w, h, spp, 5, 4, 4,
                                    [(seed, xs.ravel(), ys.ravel())], "cpu",
                                    table_from=0 if rng_mode == "table" else None)
    nums = check.pixels(prog, ref)
    assert nums["pixels_off"] == 0.0 and nums["median_gap"] < 1e-6


def test_train_steps_match_port():
    from pt_three_ways_tpu_torch.models.materials import MaterialTable
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    w = h = 12
    seed = 2 ** 40 + 7
    params = RenderParams(width=w, height=h, intersector="kernel")
    sc, cam, params = _port_scene("suzanne", params)
    m = sc.materials
    rows = torch.cat([m.emission, m.diffuse, m.ior[:, None], m.reflectivity[:, None],
                      m.cone_angle[:, None]], 1).numpy()
    p0 = torch.as_tensor(inputs.perturb(rows, seed, 0.2))
    mats = MaterialTable(p0[:, 0:3].contiguous(), p0[:, 3:6].contiguous(), p0[:, 6].contiguous(),
                         p0[:, 7].contiguous(), p0[:, 8].contiguous())
    n = w * h
    px = (torch.arange(n) % w).to(torch.int32)
    py = (torch.arange(n) // w).to(torch.int32)
    tgt = inputs.target(seed, n, "cpu")
    step = make_sharded_train_step(sc, params, mesh=None, fused="auto", device="cpu")
    st, losses, tabs = TrainState(mats, cam, 0), [], [p0.double().numpy()]
    for i in range(3):
        loss, st = step(st, torch.tensor(list(inputs.step_key(seed, i))), px, py, tgt)
        losses.append(float(loss))
        mm = st.materials
        tabs.append(torch.cat([mm.emission, mm.diffuse, mm.ior[:, None], mm.reflectivity[:, None],
                               mm.cone_angle[:, None]], 1).double().numpy())
    rs = ref_scene.build(_config("suzanne"), w, h)
    geo = Geometry(rs, "cpu", torch.float64, torch.float32)
    r0 = torch.as_tensor(inputs.perturb(rs.materials.astype(np.float32), seed, 0.2),
                         dtype=torch.float64)
    rl, rt, _ = ref_train.steps(rs, geo, r0, [inputs.step_key(seed, i) for i in range(3)],
                                px.long(), py.long(), tgt, 0.05, 4)
    nums = check.training(losses, rl, tabs, [t.numpy() for t in rt], 0.05)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3 and nums["change_gap"] < 1e-3
