"""Multi-process runs of the port (``parallel/distributed.py``) on the CPU:
two ``gloo`` ranks on 127.0.0.1, started once per module with
``distributed.spawn`` (one intra-op thread each), the counterpart of the
JAX package's tests/test_distributed.py.

  * The two processes all-reduce over ``global_mesh(dp=2)``.
  * The elastic per-host render: each process renders its own sample range
    (samples [0, 2) and [2, 4)) on its device, writes its own checkpoint
    (``host_local_checkpoint_path``), and ``merge_host_checkpoints`` of the
    two equals a single 4-sample render, counts exactly.
  * ``cli --devices 2 --device cpu --raw`` (which starts its own two ranks)
    equals the JAX package's CLI with ``--devices 2`` (``render_sharded``
    on ``make_mesh(n_devices=2)``) within 1e-6.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

if multiprocessing.parent_process() is None:  # not in the spawned ranks
    from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

PARAMS = dict(width=16, height=16, first_bounce_u_samples=2, first_bounce_v_samples=2,
              max_depth=3, seed=9)


def _scene(spp):
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder

    params = RenderParams(samples_per_pixel=spp, **PARAMS)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    return sb.build(), camera, params


def _rank(base):
    import torch.distributed as dist

    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.parallel.distributed import (global_mesh,
                                                               host_local_checkpoint_path)
    from pt_three_ways_tpu_torch.parallel.mesh import all_reduce

    torch.set_num_threads(1)
    rank = dist.get_rank()
    mesh = global_mesh(dp=2, device="cpu")
    total = all_reduce(torch.arange(4, dtype=torch.float32) + 4 * rank, mesh.group)
    # this process's sample range, [2*rank, 2*rank + 2): the first 2*(rank+1)
    # samples less the prefix the other process renders
    out = render(*_scene(2 * (rank + 1)), device="cpu")
    if rank == 1:
        prefix = render(*_scene(2), device="cpu")
        out.sum -= prefix.sum
        out.count -= prefix.count
    path = host_local_checkpoint_path(base)
    out.save(path)
    return dict(shape=mesh.shape, total=total.numpy(), path=path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from pt_three_ways_tpu_torch.parallel import distributed

    base = str(tmp_path_factory.mktemp("hosts") / "render.raw")
    return base, distributed.spawn(_rank, 2, base, device="cpu", threads=1, timeout=300)


def test_two_process_all_reduce_over_global_mesh(ranks):
    _, r = ranks
    assert r["shape"] == {"dp": 2, "sp": 1}
    np.testing.assert_array_equal(r["total"], np.arange(4) * 2 + 4.0)


def test_each_process_renders_its_own_sample_range(ranks):
    base, r = ranks
    root, ext = os.path.splitext(base)
    assert r["path"] == f"{root}.host0{ext}"
    for k in (0, 1):
        part = ArrayOutput.load(f"{root}.host{k}{ext}")
        assert (part.count == 2).all()
        assert np.isfinite(part.sum).all()


def test_merged_host_checkpoints_equal_single_render(ranks):
    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.parallel.distributed import merge_host_checkpoints

    base, _ = ranks
    merged = merge_host_checkpoints(base, base + ".merged")
    assert (merged.count == 4).all()
    single = render(*_scene(4), device="cpu")
    np.testing.assert_allclose(merged.sum, single.sum, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(merged.count, single.count)
    np.testing.assert_array_equal(ArrayOutput.load(base + ".merged").sum, merged.sum)


def test_cli_two_devices_matches_jax_render_sharded(tmp_path, capfd):
    from pt_three_ways_tpu.cli import main as cli_j

    from pt_three_ways_tpu_torch.cli import main as cli_t

    argv = ["-w", "16", "-h", "16", "--spp", "4", "--seed", "9", "--first-bounce-u", "2",
            "--first-bounce-v", "2", "--max-depth", "3", "--save-every", "0", "--raw",
            "--devices", "2", "--scene", "cornell"]
    got, want = str(tmp_path / "port.raw"), str(tmp_path / "jax.raw")
    assert cli_t([*argv, "--device", "cpu", got]) == 0
    text = capfd.readouterr().out  # the ranks' own processes print
    assert text.count("Scene contains 38 triangles and 1 spheres.") == 1
    assert text.count("Total samples: 1024") == 1
    assert cli_j([*argv, want]) == 0
    a, b = ArrayOutput.load(got), ArrayOutput.load(want)
    np.testing.assert_allclose(a.sum, b.sum, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a.count, b.count)
