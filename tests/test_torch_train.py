"""The port's training step (parallel/train.py, one device) against the JAX
package's ``make_sharded_train_step`` on a one-device mesh, on the CPU.

The JAX scene and camera are carried into the port
(``models/scene.from_jax_arrays``); the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions (``intersector=
"kernel"`` on CPU tensors).

  * The replay path (``fused="auto"``: K7 forward, K8 backward), two steps:
    each step's loss within rtol 1e-5, and each material field's update
    (new - old, that is learning rate x gradient) within 1e-4 of the
    field's largest update; the ior update within 1e-3 (the ior gradient of
    an ior-1 Fresnel material is rounding noise, see
    tests/test_torch_replay.py).
  * The regenerating replay path (``passes_per_step=3``: K4 in replay mode
    forward, K9 backward), two steps, the same gates.
  * The per-bounce wavefront (``fused="off"``) with camera gradients, whose
    winner distances differentiate through K2's VJP: one step, the same
    gates for the loss, the materials and every camera field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.parallel.mesh import make_mesh
from pt_three_ways_tpu.parallel.train import TrainState as TSj
from pt_three_ways_tpu.parallel.train import make_sharded_train_step as step_j
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
from test_torch_replay import make_pair
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

LR = 0.05


def _assert_updates_close(new, new_j, old, names):
    for a, b, o, name in zip(new, new_j, old, names):
        a = a.detach().numpy()
        b, o = np.asarray(b), np.asarray(o)
        assert np.isfinite(a).all(), name
        tol = 1e-3 if name == "ior" else 1e-4
        scale = max(np.abs(b - o).max(), 1e-6)
        np.testing.assert_allclose(a - o, b - o, rtol=0, atol=tol * scale, err_msg=name)


def _target(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)


def test_replay_train_steps_match_jax():
    pj, sj, cam_j, pt, st, cam_t, px, py = make_pair("cornell")
    target = _target(px.size, 5)
    sj_step = step_j(sj, pj, make_mesh(n_devices=1), learning_rate=LR)
    st_step = make_sharded_train_step(st, pt, learning_rate=LR, device="cpu")
    state_j = TSj(sj.materials, cam_j, jnp.int32(0))
    state_t = TrainState(st.materials, cam_t, 0)
    args_t = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(target))
    args_j = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(target))
    for seed in (3, 4):
        loss_j, new_j = sj_step(state_j, rj.base_key(seed), *args_j)
        loss_t, new_t = st_step(state_t, rt.base_key(seed), *args_t)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        _assert_updates_close(new_t.materials, new_j.materials, state_j.materials,
                              new_j.materials._fields)
        assert new_t.step == state_t.step + 1
        state_j, state_t = new_j, new_t
    moved = (state_t.materials.diffuse - st.materials.diffuse).abs().sum()
    assert float(moved) > 0.0


def test_regen_replay_train_steps_match_jax():
    pj, sj, cam_j, pt, st, cam_t, px, py = make_pair("cornell")
    target = _target(px.size, 7)
    sj_step = step_j(sj, pj, make_mesh(n_devices=1), learning_rate=LR, passes_per_step=3)
    st_step = make_sharded_train_step(st, pt, learning_rate=LR, passes_per_step=3,
                                      device="cpu")
    state_j = TSj(sj.materials, cam_j, jnp.int32(0))
    state_t = TrainState(st.materials, cam_t, 0)
    args_t = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(target))
    args_j = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(target))
    for seed in (3, 4):
        loss_j, new_j = sj_step(state_j, rj.base_key(seed), *args_j)
        loss_t, new_t = st_step(state_t, rt.base_key(seed), *args_t)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        _assert_updates_close(new_t.materials, new_j.materials, state_j.materials,
                              new_j.materials._fields)
        state_j, state_t = new_j, new_t
    moved = (state_t.materials.diffuse - st.materials.diffuse).abs().sum()
    assert float(moved) > 0.0


def test_passes_per_step_needs_the_replay_path():
    _, _, _, pt, st, _, _, _ = make_pair("cornell")
    with pytest.raises(ValueError, match="replay path"):
        make_sharded_train_step(st, pt, fused="off", passes_per_step=2, device="cpu")


def test_wavefront_step_with_camera_gradients_matches_jax():
    pj, sj, cam_j, pt, st, cam_t, px, py = make_pair("cornell")
    target = _target(px.size, 6)
    kw = dict(learning_rate=LR, fused="off", differentiate_camera=True)
    sj_step = step_j(sj, pj, make_mesh(n_devices=1), **kw)
    st_step = make_sharded_train_step(st, pt, device="cpu", **kw)
    loss_j, new_j = sj_step(TSj(sj.materials, cam_j, jnp.int32(0)), rj.base_key(8),
                            jnp.asarray(px), jnp.asarray(py), jnp.asarray(target))
    loss_t, new_t = st_step(TrainState(st.materials, cam_t, 0), rt.base_key(8),
                            torch.from_numpy(px), torch.from_numpy(py),
                            torch.from_numpy(target))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_updates_close(new_t.materials, new_j.materials, sj.materials,
                          new_j.materials._fields)
    _assert_updates_close(new_t.camera, new_j.camera, cam_j, new_j.camera._fields)
    moved = sum(float((a - b).abs().sum()) for a, b in zip(new_t.camera, cam_t))
    assert moved > 0.0


def test_train_demo_lowers_the_albedo_error():
    """The port of tools/train_demo.py on the CPU at 8^2: three Adam steps
    through trace_passes_replay move the observable albedos toward the
    truth."""
    from pt_three_ways_tpu_torch import train_demo

    r = train_demo.run(steps=3, res=8, device="cpu", log=lambda *_: None)
    assert np.isfinite([r["loss0"], r["loss1"]]).all()
    assert r["observable"] > 0 and r["err1"] < r["err0"]


def test_unported_options_raise():
    """A dp that does not divide the device count raises, as in the JAX
    package's make_mesh (meshes themselves: tests/test_torch_sharding.py)."""
    from pt_three_ways_tpu_torch.parallel.mesh import make_mesh

    _, _, _, pt, st, _, _, _ = make_pair("cornell")
    with pytest.raises(ValueError, match="dp=2 does not divide device count 1"):
        make_sharded_train_step(st, pt, mesh=make_mesh(dp=2, device="cpu"), device="cpu")
