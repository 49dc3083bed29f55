"""The port's smallpt sidecar (models/smallpt.py) against the JAX package's,
on the CPU.

The JAX side runs jitted, as its render runs it; the port's CPU path
contracts the products XLA's CPU code contracts (ops/xla_cpu.fma), so:

  * the scene arrays, ``_intersect``'s t and index on 2048 seeded rays, and
    ``render_smallpt(16, 16, spp=4, seed=3, max_bounces=8)`` are bit-equal
    to the JAX package's (tolerance: none);
  * ``_intersect`` tracks a float64 oracle to the gates of
    tests/test_smallpt.py (index agreement > 0.999, mean |dt| < 0.02,
    99.5th percentile < 0.05);
  * the render is deterministic, has the walls' colours, and the CLI's
    ``--scene smallpt --raw`` file equals the JAX CLI's byte for byte.
"""

import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models import smallpt as sp_j
from pt_three_ways_tpu_torch.cli import main as cli_main
from pt_three_ways_tpu_torch.models import smallpt as sp
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)


def test_scene_bit_equal_to_jax():
    sj, st = sp_j.smallpt_scene(), sp.smallpt_scene()
    for f in sp.SmallptScene._fields:
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (sp.DIFF, sp.SPEC, sp.REFR, sp.EPS) == (sp_j.DIFF, sp_j.SPEC, sp_j.REFR, sp_j.EPS)
    np.testing.assert_array_equal(st.table()[:, 9].numpy(), np.asarray(sj.refl_type))


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1234)
    o = rng.uniform(0, 100, (3, 2048)).astype(np.float32)
    d = rng.normal(size=(3, 2048))
    return o, (d / np.linalg.norm(d, axis=0)).astype(np.float32)


def test_intersect_matches_jax_and_f64_oracle(rays):
    import jax
    import jax.numpy as jnp

    o, d = rays
    t_j, i_j = jax.jit(sp_j._intersect)(sp_j.smallpt_scene(), jnp.asarray(o), jnp.asarray(d))
    t, i = sp._intersect(sp.smallpt_scene(), torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))

    c = np.array([s[1] for s in sp._SPHERES])
    r = np.array([s[0] for s in sp._SPHERES])
    op = c[:, :, None] - o.astype(np.float64)[None, :, :]
    b = (op * d.astype(np.float64)[None]).sum(1)
    det = b * b - (op * op).sum(1) + (r * r)[:, None]
    sq = np.sqrt(np.maximum(det, 0))
    mt, pt = b - sq, b + sq
    tt = np.where(mt > sp.EPS, mt, pt)
    tt = np.where((det >= 0) & (tt > sp.EPS), tt, np.inf)
    best, idx = tt.min(0), tt.argmin(0)
    hit = np.isfinite(best)
    assert (i.numpy()[hit] == idx[hit]).mean() > 0.999
    err = np.abs(t.numpy()[hit] - best[hit])
    assert err.mean() < 0.02
    assert np.percentile(err, 99.5) < 0.05


def test_render_matches_jax_and_is_deterministic():
    ref = sp_j.render_smallpt(16, 16, spp=4, seed=3, max_bounces=8)
    a = sp.render_smallpt(16, 16, spp=4, seed=3, max_bounces=8, device="cpu")
    assert a.shape == (16, 16, 3) and np.isfinite(a).all()
    assert (a >= 0).all() and (a <= 1).all()  # subpixel-clamped
    np.testing.assert_array_equal(a, ref)
    b = sp.render_smallpt(16, 16, spp=4, seed=3, max_bounces=8, device="cpu")
    np.testing.assert_array_equal(a, b)
    c = sp.render_smallpt(16, 16, spp=4, seed=4, max_bounces=8, device="cpu")
    assert not np.array_equal(a, c)


def test_left_right_wall_colours():
    # left wall red, right wall blue (smallpt.cpp:58-61), as tests/test_smallpt.py
    img = sp.render_smallpt(48, 36, spp=16, seed=2, max_bounces=10, device="cpu")
    left = img[10:26, :6]
    right = img[10:26, -6:]
    assert left[..., 0].mean() > left[..., 2].mean() * 1.3
    assert right[..., 2].mean() > right[..., 0].mean() * 1.3
    assert img.mean() > 0.05


def test_cli_raw_matches_jax_cli(tmp_path, capsys):
    from pt_three_ways_tpu.cli import main as cli_main_j

    args = ["-w", "8", "-h", "6", "--spp", "4", "--seed", "3", "--scene", "smallpt", "--raw"]
    out_t, out_j = str(tmp_path / "t.raw"), str(tmp_path / "j.raw")
    assert cli_main([*args, "--device", "cpu", out_t]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "Total samples: 192" and lines[2].startswith("Samples/ms: ")
    assert cli_main_j([*args, out_j]) == 0
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
