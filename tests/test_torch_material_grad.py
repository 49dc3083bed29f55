"""The material gather's VJP (``models/integrator._MaterialGather``, kernel
K12 in ``ops/material_grad``) on the CPU, where it takes K12's plain
version (a lane-order ``index_add_``).

  * The Function's forward equals the plain indexed loads bit for bit, and
    its table gradients equal autograd's of those loads to float32
    rounding (rtol 1e-6, atol 1e-6 of the largest): for 1, 4 and 340
    materials over 1, 257 and 1,024 lanes, some materials in no lane, with
    every cotangent given and with some of them None.
  * The plain version against a float64 sum, and the wrapper's refusals.
  * A render never enters the Function (its table does not require grad):
    no K12 call, and the image of the plain loads.
  * A train step goes through the Function once a pass: the replay path
    (one pass) and the regenerating one (two passes a step).
"""

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.materials import MaterialTable
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import material_grad as mg
from pt_three_ways_tpu_torch.ops import rng
from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
from pt_three_ways_tpu_torch.utils.render_params import RenderParams
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

FIELDS = MaterialTable._fields


def _table(n_mat, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, dtype=dtype)
    return MaterialTable(r(n_mat, 3), r(n_mat, 3), 1.0 + r(n_mat), r(n_mat) - 0.5, r(n_mat))


def _ids(n_mat, n, seed):
    """Runs of one material (as neighbouring pixels hit), then lanes at
    random; with more than one material, material n_mat // 2 in no lane."""
    rs = np.random.default_rng(seed)
    pool = [m for m in range(n_mat) if n_mat == 1 or m != n_mat // 2]
    ids = np.repeat(rs.choice(pool, size=n), rs.integers(1, 40, size=n))[:n // 2]
    ids = np.concatenate([ids, rs.choice(pool, size=n - ids.size)])
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("used", ["all", "emission+ior", "diffuse"])
@pytest.mark.parametrize("n", [1, 257, 1024])
@pytest.mark.parametrize("n_mat", [1, 4, 340])
def test_gather_function_matches_indexed_loads(n_mat, n, used):
    table = _table(n_mat, n_mat + n)
    ids = _ids(n_mat, n, n)
    picked = [i for i, f in enumerate(FIELDS) if used == "all" or f in used.split("+")]
    grads, outs = [], []
    for gather in (integ.gather_materials, integ._loads):
        leaves = [t.clone().requires_grad_() for t in table]
        out = gather(MaterialTable(*leaves), ids)
        outs.append(out)
        g = torch.Generator().manual_seed(1)
        cots = [torch.randn(out[i].shape, generator=g) for i in picked]
        got = torch.autograd.grad([out[i] for i in picked], leaves, cots, allow_unused=True)
        grads.append([torch.zeros_like(x) if d is None else d for d, x in zip(got, leaves)])
    assert type(outs[0][0].grad_fn).__name__ == "_MaterialGatherBackward"
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for name, a, b in zip(FIELDS, *grads):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * scale, msg=name)
    if n_mat > 1 and n > 1:
        assert all(float(a[n_mat // 2].abs().max()) == 0.0 for a in grads[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_material_grad_matches_a_float64_sum(dtype):
    n_mat, n = 7, 5000
    ids = _ids(n_mat, n, 3)
    cot = torch.randn((9, n), generator=torch.Generator().manual_seed(4), dtype=dtype)
    got = mg.material_grad(ids, cot, n_mat)
    ref = np.zeros((n_mat, 9))
    np.add.at(ref, ids.numpy(), cot.double().numpy().T)
    scale = np.zeros((n_mat, 9))
    np.add.at(scale, ids.numpy(), np.abs(cot.double().numpy().T))
    eps = torch.finfo(dtype).eps
    assert got.shape == (n_mat, 9) and got.dtype == dtype
    assert (np.abs(got.double().numpy() - ref) <= n * eps * scale).all()
    assert mg.material_grad(ids[:0], cot[:, :0], n_mat).abs().max() == 0.0


def test_material_grad_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros((8,), dtype=torch.int32)
    cot = torch.zeros((9, 8))
    with pytest.raises(ValueError, match="ids \\[N\\], cot \\[9, N\\]"):
        mg.material_grad(ids, cot[:8], 2)
    with pytest.raises(ValueError, match="int32 ids"):
        mg.material_grad(ids.long(), cot, 2)
    with pytest.raises(ValueError, match="int32 ids"):
        mg.material_grad(ids, cot.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        mg.material_grad(ids, torch.zeros((8, 9)).T, 2)
    assert mg.k12_blocks(0) == 1 and mg.k12_blocks(262144) == 256
    assert mg.k12_blocks(4194304) == mg.K12_MAX_BLOCKS


def _scene(name, side, **kw):
    params = RenderParams(width=side, height=side, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=3, **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params)
    return sb.build(), camera, params


def _count_k12(monkeypatch):
    calls = []
    orig = integ.material_grad

    def counted(*a):
        calls.append(a[0].shape[0])
        return orig(*a)

    monkeypatch.setattr(integ, "material_grad", counted)
    return calls


@pytest.mark.parametrize("way", ["dod", "oo", "fp"])
def test_render_never_enters_the_function(monkeypatch, way):
    scene, camera, params = _scene("cornell", 8, samples_per_pixel=2, seed=3)
    before = render(scene, camera, params, way=way, device="cpu")
    calls = _count_k12(monkeypatch)

    def refused(*a):
        raise AssertionError("a render entered the material gather's Function")

    monkeypatch.setattr(integ._MaterialGather, "apply", refused)
    got = render(scene, camera, params, way=way, device="cpu")
    monkeypatch.setattr(integ, "gather_materials", integ._loads)
    plain = render(scene, camera, params, way=way, device="cpu")
    assert calls == []
    assert np.array_equal(got.sum, plain.sum) and np.array_equal(got.sum, before.sum)
    assert np.array_equal(got.count, before.count)


@pytest.mark.parametrize("passes", [1, 2])
def test_train_step_enters_the_function_once_a_pass(monkeypatch, passes):
    scene, camera, params = _scene("cornell", 6, intersector="kernel")
    n = 36
    px = torch.arange(n, dtype=torch.int32) % 6
    py = torch.arange(n, dtype=torch.int32) // 6
    target = torch.full((n, 3), 0.25)
    step = make_sharded_train_step(scene, params, learning_rate=0.05, device="cpu",
                                   passes_per_step=passes)
    calls = _count_k12(monkeypatch)
    state = TrainState(scene.materials, camera, 0)
    for i in range(2):
        loss, state = step(state, rng.base_key(2 + i), px, py, target)
        assert len(calls) == passes * (i + 1)
    assert calls == [n] * (2 * passes)
    assert np.isfinite(float(loss))
    assert any(float((a - b).abs().max()) > 0 for a, b in zip(state.materials, scene.materials))
