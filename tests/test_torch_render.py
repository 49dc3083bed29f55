"""The port's render loop and CLI on the CPU.

  * The scan-wavefront CPU render reproduces all seven golden images at the
    golden tolerance (tests/test_golden_images.py: atol 5e-5, rtol 5e-4) —
    draw for draw, since threefry and the CPU rounding follow the JAX
    package.
  * The regen path (``intersector="kernel"``: the camera stage through K2's
    plain version, then K4's) matches the JAX package's
    ``render(intersector="pallas-interpret")`` by 4x4 block means (rtol 2e-2,
    atol 2e-3: both draw the same streams, but a near-tie winner flips a
    whole path) and on >= 90 % of pixels to 1e-4.
  * ``resume_from`` continues bit-identically; autotune makes the JAX
    package's decisions; the CLI runs on ``--device cpu`` and a CUDA
    request without a card raises.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.cli import main as cli_main
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.render import autotune_decisions, render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_images import CASES, GOLDEN_DIR  # noqa: E402
from test_torch_megakernel import one_torch_thread  # noqa: E402, F401 (autouse fixture)


def _render(scene_name, device="cpu", **kw):
    params = RenderParams(**kw)
    sb = SceneBuilder()
    camera = create_scene(sb, scene_name, params)
    return render(sb.build(), camera, params, device=device)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_render_reproduces_golden(name):
    cfg = CASES[name]
    out = _render(cfg["scene"], width=cfg["width"], height=cfg["height"],
                  samples_per_pixel=cfg["spp"], seed=11, first_bounce_u_samples=2,
                  first_bounce_v_samples=2, max_depth=4)
    img = out.mean().astype(np.float32)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    assert img.shape == golden.shape
    np.testing.assert_allclose(img, golden, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_kernel_path_matches_jax_pallas_interpret(name):
    from pt_three_ways_tpu.models.catalog import create_scene as create_j
    from pt_three_ways_tpu.models.render import render as render_j
    from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
    from pt_three_ways_tpu.utils.render_params import RenderParams as RPj

    kw = dict(width=16, height=16, samples_per_pixel=2, seed=5,
              first_bounce_u_samples=2, first_bounce_v_samples=2, max_depth=4)
    sb = SBj()
    cam = create_j(sb, name, RPj(**kw))
    ref = render_j(sb.build(), cam, RPj(intersector="pallas-interpret", **kw)).mean()
    got = _render(name, intersector="kernel", **kw).mean()
    pix = np.all(np.isclose(got, ref, rtol=1e-4, atol=1e-4), axis=2)
    assert pix.mean() >= 0.9, pix.mean()
    blocks = lambda a: a.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(blocks(got), blocks(ref), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("intersector", ["xla", "kernel"])
def test_resume_bit_identical(tmp_path, intersector):
    kw = dict(width=8, height=8, seed=3, first_bounce_u_samples=2,
              first_bounce_v_samples=2, max_depth=3, intersector=intersector)
    full = _render("cornell", samples_per_pixel=3, **kw)
    part = _render("cornell", samples_per_pixel=1, **kw)
    ckpt = str(tmp_path / "part.raw")
    part.save(ckpt)
    params = RenderParams(samples_per_pixel=3, **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    resumed = render(sb.build(), camera, params, resume_from=ckpt, device="cpu")
    np.testing.assert_array_equal(resumed.sum, full.sum)
    np.testing.assert_array_equal(resumed.count, full.count)
    bad = ArrayOutput(4, 4)
    bad.save(str(tmp_path / "bad.raw"))
    with pytest.raises(ValueError):
        render(sb.build(), camera, params, resume_from=str(tmp_path / "bad.raw"),
               device="cpu")


def test_autotune_decisions_match_jax(rng_np):
    from pt_three_ways_tpu.models.render import autotune_decisions as decide_j

    cases = [
        (np.full(4096, 26), 8, 4, 38, 1),  # closed small scene
        (np.full(4096, 26), 8, 4, 968, 2),  # closed but large
        (rng_np.integers(0, 20, 5000), 8, 4, 970, 2),  # open, divergent
        (np.zeros(3000, np.int64), 8, 4, 12, 3),  # everything dies at once
        (np.where(rng_np.random(6000) < 0.02, 30, 0), 8, 4, 12, 3),  # sparse
        (rng_np.integers(0, 3, 100), 1, 0, 0, 5),
    ]
    for counts, s0, nb, nt, ns in cases:
        assert autotune_decisions(counts, s0, nb, nt, ns) == decide_j(counts, s0, nb, nt, ns)


def test_cli_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    rc = cli_main(["-w", "8", "-h", "6", "--spp", "1", "--seed", "2", "--save-every", "0",
                   "--scene", "single-sphere", "--device", "cpu", out])
    assert rc == 0 and os.path.getsize(out) > 0
    text = capsys.readouterr().out
    assert "Scene contains 0 triangles and 3 spheres." in text
    assert "Total samples: 48" in text and "Samples/ms:" in text
    raw = str(tmp_path / "img.raw")
    assert cli_main(["-w", "8", "-h", "6", "--spp", "1", "--seed", "2", "--raw",
                     "--save-every", "0", "--device", "cpu", raw]) == 0
    assert ArrayOutput.load(raw).total_samples() == 48
    for bad in (["--devices", "2", "--dp", "3"], ["--dtype", "float64", "--device", "cuda"],
                ["--scene", "nope"], ["--way", "zz"]):
        assert cli_main(["-w", "4", "-h", "4", "--device", "cpu", *bad, out]) == 1
    for ok in (["--way", "oo"], ["--way", "functional"], ["--scene", "smallpt"],
               ["--dtype", "float64"], ["--devices", "2"]):
        assert cli_main(["-w", "4", "-h", "4", "--spp", "1", "--max-depth", "3",
                         "--save-every", "0", "--device", "cpu", *ok, out]) == 0


def test_cuda_request_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        _render("single-sphere", device="cuda", width=4, height=4, samples_per_pixel=1)
    with pytest.raises(RuntimeError):
        cli_main(["-w", "4", "-h", "4", "--spp", "1", str(tmp_path / "x.png")])
