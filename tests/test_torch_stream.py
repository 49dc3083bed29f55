"""K4's stream mode with K6 (ops/megakernel: PackedSceneStream,
stream_search_plain, fused_passes_krng(stream=True)) on the CPU.

  * The window tables: ``wbox`` is the min/max of each window's
    Morton-ordered vertices (the last window padded with the last vertex)
    widened by the margin, the window count is ceil(T / window), and the
    padding Woop rows are zero; ``wbox1`` holds one box per ``fan``
    windows, the min/max of their widened boxes.
  * The two-level walk (``stream_search_plain``) finds the resident
    winners bit for bit on rays aimed at shared window edges, on suzanne,
    -sub1 and -sub2, at fans 8 and 16: packed (K6, the culled K4) and
    unpacked (K7's culled search: the exact minimum, the lowest index on a
    tie, a window skipped only when its box entry is at or beyond best_t);
    on a mesh of one triangle repeated across two windows the lowest index
    wins.
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
  * ``uses_stream`` routes scenes above ``RESIDENT_MAX_TRIANGLES`` (the
    measured resident range) to the stream tier and the catalog's meshes,
    -sub3 included, to the resident K4; a CPU ``render()`` routed to the
    stream tier equals the resident render bit for bit.
  * The card's K4 and K7 need a ``PackedSceneStream`` (their culled
    searches read its window boxes): the render, both training chains and
    the train step build one (the step once per geometry, its material rows
    refreshed each step by ``with_materials``, which equals a new pack bit
    for bit), and the card's launches raise on a ``PackedSceneFused``.
"""

import functools

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models import replay
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.materials import MaterialSpec
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng
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


@pytest.mark.parametrize("packed_winner", [True, False])
@pytest.mark.parametrize("fan", [8, 16])
@pytest.mark.parametrize("name", ["suzanne", "suzanne-sub1", "suzanne-sub2"])
def test_hierarchical_stream_search_matches_resident_bitwise(name, fan, packed_winner):
    """The two-level walk (level-1 boxes, then their windows) finds the
    resident scan's winners bit for bit on rays aimed at the edges two
    windows share (every edge's rays on suzanne; on -sub1 and -sub2 an even
    subsample of about 2048 of them), with the packed winner (K6, the
    culled K4) and the unpacked one (K7)."""
    scene, _ = _scene(name)
    ps = mk.PackedSceneStream(scene, window=WINDOW, fan=fan)
    org, dirn, _ = edge_rays(scene, WINDOW)
    step = max(org.shape[1] // 2048, 1)
    org, dirn = org[:, ::step].contiguous(), dirn[:, ::step].contiguous()
    live = torch.ones(org.shape[1], dtype=torch.bool)
    t_r, i_r = mk.winner_search_plain(ps, org, dirn, live, 1e-4, packed_winner=packed_winner)
    t_s, i_s = mk.stream_search_plain(ps, org, dirn, live, 1e-4, packed_winner=packed_winner)
    assert bool(torch.isfinite(t_r).any())
    np.testing.assert_array_equal(t_s.numpy(), t_r.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_r.numpy())


@pytest.mark.parametrize("packed_winner", [True, False])
def test_culled_search_ties_take_the_lowest_index(packed_winner):
    """One triangle repeated 100 times (two windows of 64 rows): every ray
    that hits it ties on all 100 rows, and the culled walk, like the
    resident scan, takes row 0 (the lowest row in a chunk, a later chunk
    only when strictly nearer)."""
    sb = SceneBuilder()
    mat = MaterialSpec(diffuse=(0.5, 0.5, 0.5))
    for _ in range(100):
        sb.add_triangle((-1.0, -1.0, 0.0), (1.0, -1.0, 0.0), (0.0, 1.0, 0.0), mat)
    scene = sb.build(morton=False)
    ps = mk.PackedSceneStream(scene, window=WINDOW, fan=1)
    assert ps.n_windows == 2
    gen = np.random.default_rng(2)
    n = 256
    target = np.stack([gen.uniform(-0.4, 0.4, n), gen.uniform(-0.5, 0.3, n), np.zeros(n)])
    org = target + np.stack([gen.uniform(-1, 1, n), gen.uniform(-1, 1, n),
                             gen.choice([-2.0, 2.0], n)])
    dirn = (target - org) / np.linalg.norm(target - org, axis=0)
    org, dirn = (torch.from_numpy(x.astype(np.float32)) for x in (org, dirn))
    live = torch.ones(n, dtype=torch.bool)
    t_r, i_r = mk.winner_search_plain(ps, org, dirn, live, 1e-4, packed_winner=packed_winner)
    t_s, i_s = mk.stream_search_plain(ps, org, dirn, live, 1e-4, packed_winner=packed_winner)
    hit = torch.isfinite(t_r)
    assert hit.float().mean() > 0.9
    np.testing.assert_array_equal(t_s.numpy(), t_r.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_r.numpy())
    assert not i_s[hit].any()


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


def test_uses_stream_routing(monkeypatch):
    small, params = _scene("suzanne")
    assert mk.scene_fits_resident(small)
    assert not integ.uses_stream(params, small, "cpu")
    big, _ = _scene("suzanne-sub3")  # the resident K4 beat K6 up to -sub6
    assert mk.scene_fits_resident(big)
    assert not integ.uses_stream(params, big, "cpu")
    # a scene above the measured range streams
    monkeypatch.setattr(mk, "RESIDENT_MAX_TRIANGLES", small.num_triangles)
    assert not integ.uses_stream(params, small, "cpu")
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

    monkeypatch.setattr(mk, "scene_fits_resident", lambda scene: False)
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


def test_with_materials_equals_a_new_pack():
    """A training step's pack: the geometry's ``PackedSceneStream`` with
    other materials equals a new pack of the scene with those materials,
    table for table, and shares the geometry tables."""
    scene, _ = _scene("cornell")
    geo = mk.PackedSceneStream(scene)
    m = scene.materials
    mats = m._replace(diffuse=m.diffuse * 0.5, cone_angle=m.cone_angle * 0.0)
    env = scene.environment + 0.25
    got = geo.with_materials(mats, env)
    want = mk.PackedSceneStream(scene._replace(materials=mats, environment=env))
    for k, v in vars(want).items():
        if torch.is_tensor(v):
            assert torch.equal(getattr(got, k), v), k
        else:
            assert getattr(got, k) == v, k
    assert got.no_glossy and not geo.no_glossy
    assert got.tri_win is geo.tri_win and got.wbox1 is geo.wbox1


def test_card_culled_searches_need_the_window_boxes(monkeypatch):
    """The render and both training chains hand the kernels a
    ``PackedSceneStream``; the train step builds it once. The card's K4 and
    K7 raise on a ``PackedSceneFused`` before launching."""
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    packs = []
    krng = mk.fused_passes_krng
    fb = replay.fused_bounces
    monkeypatch.setattr(mk, "fused_passes_krng",
                        lambda pk, *a, **kw: packs.append(("K4", pk)) or krng(pk, *a, **kw))
    monkeypatch.setattr(replay, "fused_passes_krng",
                        lambda pk, *a, **kw: packs.append(("K4r", pk)) or krng(pk, *a, **kw))
    monkeypatch.setattr(replay, "fused_bounces",
                        lambda pk, *a, **kw: packs.append(("K7", pk)) or fb(pk, *a, **kw))
    params = RenderParams(width=4, height=4, samples_per_pixel=1, seed=5, intersector="kernel",
                          first_bounce_u_samples=1, first_bounce_v_samples=1, max_depth=3)
    sb = SceneBuilder()
    camera = create_scene(sb, "suzanne", params)
    scene = sb.build()
    render(scene, camera, params, device="cpu")
    px = torch.arange(16, dtype=torch.int32) % 4
    py = torch.arange(16, dtype=torch.int32) // 4
    target = torch.full((16, 3), 0.25)
    for s_count in (1, 2):
        step = make_sharded_train_step(scene, params, device="cpu", passes_per_step=s_count)
        state = TrainState(scene.materials, camera, 0)
        for _ in range(2):
            _, state = step(state, rng.base_key(1), px, py, target)
    kinds = [k for k, _ in packs]
    assert {"K4", "K4r", "K7"} <= set(kinds)
    assert all(isinstance(pk, mk.PackedSceneStream) for _, pk in packs)
    # one geometry pack per train step builder: its Woop windows are shared
    for kind in ("K4r", "K7"):
        steps = [pk for k, pk in packs if k == kind]
        assert len(steps) == 2 and steps[0].tri_win is steps[1].tri_win
        assert steps[0].mat9 is not steps[1].mat9
    _, st, state0, _ = _tables("suzanne")
    lanes, _, kw_t = _lanes_and_keys()
    s0 = torch.from_numpy(state0)
    pk = mk.PackedSceneFused(st)
    seeds = mk.kr.channel_seeds(*kw_t)
    amask = mk.alive_mask_words(s0, S)
    with pytest.raises(ValueError, match="PackedSceneStream"):
        mk._regen_krng_cuda(pk, lanes, amask, s0, None, seeds, 0, 1e-4, NB, S, 0,
                            pk.no_glossy, mk.BLOCK)
    st9 = s0[0:10]
    with pytest.raises(ValueError, match="PackedSceneStream"):
        mk._fused_bounces_cuda(pk, st9[0:3], st9[3:6], st9[6:9], st9[9],
                               torch.zeros((4 * NB, s0.shape[1])), 1e-4, NB, True)
