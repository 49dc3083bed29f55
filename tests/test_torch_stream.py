"""K4's stream mode with K6 (ops/megakernel: PackedSceneStream,
stream_search_plain, fused_passes_krng(stream=True)) on the CPU.

  * The window tables: ``wbox`` is the min/max of each window's
    Morton-ordered vertices (the last window padded with the last vertex)
    widened by the margin, the window count is ceil(T / window), and the
    padding Woop rows are zero; ``wbox1`` holds one box per ``fan``
    windows, the min/max of their widened boxes.
  * The two-level walk (``stream_search_plain``) finds the resident
    packed winners bit for bit on rays aimed at shared window edges, on
    suzanne, -sub1 and -sub2, at fans 8 and 16.
  * Rays aimed at the edges that two windows share: the streamed winners
    equal the resident ones bit for bit, and each triangle winner's window
    box is entered against it (the widened boxes' invariant).
  * The plain stream equals the resident plain bit for bit (``acc`` and
    ``cnt``), on suzanne cut into 16 windows of 64 and on cornell (one short
    window, a sphere among the triangles), with and without tail compaction:
    a window is skipped only where no triangle in it can win.
  * Against the JAX package's stream kernel in interpret mode on suzanne,
    per lane as K4's test (``assert_lanes_agree``: rtol 1e-4 / atol 1e-5
    and equal counts on >= 99 % of lanes; the interpret-mode kernel's
    triangle reciprocal starts from a bfloat16 estimate, so a near-tie can
    flip a path). Cornell is left out: the JAX interpret-mode stream kernel
    on it has crashed XLA in-process (tests/test_stream.py).
  * ``uses_stream`` routes suzanne-sub3 to the stream tier and suzanne to
    the resident K4; a CPU ``render()`` routed to the stream tier equals the
    resident render bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.utils.render_params import RenderParams
from test_torch_megakernel import (  # noqa: F401 (one_torch_thread: autouse fixture)
    NB,
    S,
    assert_lanes_agree,
    first_bounce_tables,
    one_torch_thread,
)
from test_torch_cuda import edge_rays
from test_torch_megakernel_krng import _lanes_and_keys

# suzanne's 970 triangles in 16 windows; cornell's 38 in one short one
WINDOW = 64



@functools.lru_cache(maxsize=None)
def _tables(name):
    return first_bounce_tables(name)


def _scene(name, **kw):
    params = RenderParams(width=8, height=8, intersector="kernel", **kw)
    sb = SceneBuilder()
    create_scene(sb, name, params)
    return sb.build(), params


@pytest.mark.parametrize("name", ["suzanne", "cornell"])
def test_stream_tables_layout(name):
    scene, _ = _scene(name)
    ps = mk.PackedSceneStream(scene, window=WINDOW)
    n = scene.num_triangles
    n_win = -(-n // WINDOW)
    assert (ps.window, ps.n_windows) == (WINDOW, n_win)
    assert ps.tri_win.shape == (n_win * WINDOW, 12)
    np.testing.assert_array_equal(ps.tri_win[:n].numpy(), ps.tri_tab[:n].numpy())
    assert not ps.tri_win[n:].any()
    verts = scene.triangles.verts.numpy().astype(np.float32)
    reach = np.abs(scene.spheres.centre.numpy()) + np.sqrt(scene.spheres.radius_sq.numpy())[:, None]
    margin = mk.WBOX_MARGIN * (1.0 + max(np.abs(verts).max(), reach.max()))
    assert ps.wbox_margin == margin
    verts = np.concatenate([verts, np.broadcast_to(verts[-1:, -1:], (n_win * WINDOW - n, 3, 3))])
    v = verts.reshape(n_win, WINDOW * 3, 3)
    want = np.concatenate([v.min(axis=1) - np.float32(margin), v.max(axis=1) + np.float32(margin),
                           np.zeros((n_win, 2), np.float32)], 1)
    np.testing.assert_array_equal(ps.wbox.numpy(), want)
    with pytest.raises(ValueError):
        mk.PackedSceneStream(scene, window=96)


@pytest.mark.parametrize("fan", [1, 8, 16])
def test_stream_group_boxes_layout(fan):
    """``wbox1``: one box per ``fan`` consecutive windows, the min/max of
    their widened boxes, which is the min/max of the group's vertices
    widened by the same margin (the last group may hold fewer windows)."""
    scene, _ = _scene("suzanne")
    ps = mk.PackedSceneStream(scene, window=WINDOW, fan=fan)
    n_win = ps.n_windows
    n_g = -(-n_win // fan)
    assert (ps.fan, ps.n_groups) == (fan, n_g)
    assert ps.wbox1.shape == (n_g, 8) and not ps.wbox1[:, 6:].any()
    n = scene.num_triangles
    verts = scene.triangles.verts.numpy().astype(np.float32)
    verts = np.concatenate([verts, np.broadcast_to(verts[-1:, -1:], (n_win * WINDOW - n, 3, 3))])
    margin = np.float32(ps.wbox_margin)
    wb = ps.wbox.numpy()
    for g in range(n_g):
        v = verts[g * fan * WINDOW:(g + 1) * fan * WINDOW].reshape(-1, 3)
        np.testing.assert_array_equal(ps.wbox1[g, 0:3].numpy(), v.min(axis=0) - margin)
        np.testing.assert_array_equal(ps.wbox1[g, 3:6].numpy(), v.max(axis=0) + margin)
        blk = wb[g * fan:(g + 1) * fan]
        assert (ps.wbox1[g, 0:3].numpy() <= blk[:, 0:3]).all()
        assert (ps.wbox1[g, 3:6].numpy() >= blk[:, 3:6]).all()
    for bad in (0, 33):
        with pytest.raises(ValueError):
            mk.PackedSceneStream(scene, window=WINDOW, fan=bad)


@pytest.mark.parametrize("fan", [8, 16])
@pytest.mark.parametrize("name", ["suzanne", "suzanne-sub1", "suzanne-sub2"])
def test_hierarchical_stream_search_matches_resident_bitwise(name, fan):
    """The two-level walk (level-1 boxes, then their windows) finds the
    resident scan's packed winners bit for bit on rays aimed at the edges
    two windows share (every edge's rays on suzanne; on -sub1 and -sub2 an
    even subsample of about 2048 of them)."""
    scene, _ = _scene(name)
    ps = mk.PackedSceneStream(scene, window=WINDOW, fan=fan)
    org, dirn, _ = edge_rays(scene, WINDOW)
    step = max(org.shape[1] // 2048, 1)
    org, dirn = org[:, ::step].contiguous(), dirn[:, ::step].contiguous()
    live = torch.ones(org.shape[1], dtype=torch.bool)
    t_r, i_r = mk.winner_search_plain(ps, org, dirn, live, 1e-4, packed_winner=True)
    t_s, i_s = mk.stream_search_plain(ps, org, dirn, live, 1e-4)
    assert bool(torch.isfinite(t_r).any())
    np.testing.assert_array_equal(t_s.numpy(), t_r.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_r.numpy())


@pytest.mark.parametrize("tail_frac", [0.0, 0.125])
@pytest.mark.parametrize("name", ["suzanne", "cornell"])
def test_stream_plain_matches_resident_bitwise(name, tail_frac):
    _, st, state0, _ = _tables(name)
    lanes, _, kw_t = _lanes_and_keys()
    s0 = torch.from_numpy(state0)
    ps = mk.PackedSceneStream(st, window=WINDOW)
    args = (s0, lanes, kw_t, 3, 1e-4, NB, S)
    acc_r, cnt_r = mk.fused_passes_krng(mk.PackedSceneFused(st), *args, tail_frac=tail_frac)
    acc_s, cnt_s = mk.fused_passes_krng(ps, *args, tail_frac=tail_frac, stream=True)
    assert mk.fused_passes_krng.launches == 0
    assert cnt_r.sum() > 0
    np.testing.assert_array_equal(acc_s.numpy(), acc_r.numpy())
    np.testing.assert_array_equal(cnt_s.numpy(), cnt_r.numpy())


def test_stream_window_skip_is_exercised():
    """The suzanne case above skips windows: some live rays' winners are
    found without scanning every window (so the bitwise test covers the
    skip, not only the scan)."""
    _, st, state0, _ = _tables("suzanne")
    ps = mk.PackedSceneStream(st, window=WINDOW)
    org, dirn = torch.from_numpy(state0[0:3]), torch.from_numpy(state0[3:6])
    live = torch.from_numpy(state0[9] != 0)
    t_r, i_r = mk.winner_search_plain(ps, org, dirn, live, 1e-4, packed_winner=True)
    t_s, i_s = mk.stream_search_plain(ps, org, dirn, live, 1e-4)
    np.testing.assert_array_equal(t_s.numpy(), t_r.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_r.numpy())
    t_sph, _ = mk.sphere_search_plain(ps, org, dirn, live, 1e-4)
    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn, torch.full_like(dirn, 1e-20))
    # windows a live ray enters against its final winner: fewer than all
    entered = torch.stack([mk.window_enter_plain(ps.wbox[w], org, inv, t_r, 1e-4) & live
                           for w in range(ps.n_windows)])
    assert 0 < entered.sum() < live.sum() * ps.n_windows
    assert bool(torch.isfinite(t_sph[live]).any())  # suzanne's spheres seed some winners


@pytest.mark.parametrize("name", ["suzanne", "suzanne-sub1"])
def test_stream_exact_on_edges_shared_between_windows(name):
    """Rays at the edges two windows share: the streamed search finds the
    resident scan's winner bit for bit, and every ray whose winner is a
    triangle enters that triangle's window box against its final winner
    (the exactness invariant the widened boxes guarantee)."""
    scene, _ = _scene(name)
    ps = mk.PackedSceneStream(scene, window=WINDOW)
    org, dirn, ids = edge_rays(scene, WINDOW)
    live = torch.ones(org.shape[1], dtype=torch.bool)
    t_r, i_r = mk.winner_search_plain(ps, org, dirn, live, 1e-4, packed_winner=True)
    t_s, i_s = mk.stream_search_plain(ps, org, dirn, live, 1e-4)
    np.testing.assert_array_equal(t_s.numpy(), t_r.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_r.numpy())
    on_pair = (i_r[None] == ids).any(dim=0) & torch.isfinite(t_r)
    # a fifth of the rays take one of the edge's two triangles (the others
    # meet the mesh elsewhere first); with unwidened boxes, 7 (suzanne) and
    # 19 (-sub1) of them break the invariant below, and on -sub1 the
    # streamed winners differ
    assert on_pair.float().mean() > 0.15
    tri = torch.isfinite(t_r) & (i_r < ps.n_tri)
    win = i_r[tri].long() // WINDOW
    t_top = (t_r[tri].view(torch.int32) | 63).view(torch.float32)
    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn, torch.full_like(dirn, 1e-20))
    box = ps.wbox[win].T  # [8, R]
    t0 = (box[0:3] - org[:, tri]) * inv[:, tri]
    t1 = (box[3:6] - org[:, tri]) * inv[:, tri]
    tmin = torch.minimum(t0, t1).amax(dim=0)
    tmax = torch.maximum(t0, t1).amin(dim=0)
    assert bool(((tmin <= t_top) & (tmax >= torch.clamp(tmin, min=1e-4))).all())


def test_stream_plain_matches_jax_stream_kernel():
    import jax.numpy as jnp

    from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneStream as PSj
    from pt_three_ways_tpu.ops.pallas_megakernel import fused_passes_krng as fk_j

    sj, st, state0, _ = _tables("suzanne")
    lanes, kw_j, kw_t = _lanes_and_keys()
    acc_j, cnt_j = fk_j(PSj(sj), sj.environment, jnp.asarray(state0),
                        jnp.asarray(lanes.numpy()), kw_j, 3, 1e-4, NB, S, interpret=True,
                        stream=True)
    acc_t, cnt_t = mk.fused_passes_krng(mk.PackedSceneStream(st, window=WINDOW),
                                        torch.from_numpy(state0), lanes, kw_t, 3, 1e-4, NB, S,
                                        stream=True)
    assert_lanes_agree(acc_t.numpy(), cnt_t.numpy(), np.asarray(acc_j), np.asarray(cnt_j))


def test_uses_stream_routing():
    small, params = _scene("suzanne")
    assert mk.scene_fits_resident(small, "cpu")
    assert not integ.uses_stream(params, small, "cpu")
    sub1, _ = _scene("suzanne-sub1")  # 182 KB of Woop rows: fits the 228 KB
    assert mk.scene_fits_resident(sub1, "cpu")
    big, _ = _scene("suzanne-sub3")
    assert integ.uses_stream(params, big, "cpu")
    assert not integ.uses_stream(params.replace(rng_mode="table"), big, "cpu")
    assert not integ.uses_stream(params.replace(fused="off"), big, "cpu")
    assert not integ.uses_stream(params.replace(preview=True), big, "cpu")
    assert not integ.uses_stream(params.replace(intersector="xla"), big, "cpu")


def test_stream_render_matches_resident_render(monkeypatch):
    params = RenderParams(width=8, height=8, samples_per_pixel=1, seed=5, intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, "suzanne", params)
    scene = sb.build()
    resident = render(scene, camera, params, device="cpu")
    calls = []
    search = mk.stream_search_plain

    def counted(*a, **kw):
        calls.append(1)
        return search(*a, **kw)

    monkeypatch.setattr(mk, "scene_fits_resident", lambda scene, device: False)
    monkeypatch.setattr(mk, "stream_search_plain", counted)
    streamed = render(scene, camera, params, device="cpu")
    assert calls
    np.testing.assert_array_equal(streamed.sum, resident.sum)
    np.testing.assert_array_equal(streamed.count, resident.count)


def test_replay_and_stream_raise():
    _, st, state0, _ = _tables("cornell")
    lanes, _, kw_t = _lanes_and_keys()
    args = (torch.from_numpy(state0), lanes, kw_t, 0, 1e-4, NB, S)
    with pytest.raises(ValueError):
        mk.fused_passes_krng(mk.PackedSceneStream(st), *args, stream=True, replay=True)
    with pytest.raises(ValueError):
        mk.fused_passes_krng(mk.PackedSceneFused(st), *args, stream=True)
