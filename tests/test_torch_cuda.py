"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode). On a
machine with a card: ``python -m pytest tests/test_torch_cuda.py -q``.
Tolerances as in chip_smoke.py: K2 bit for bit (``t`` and the winner
index) on cornell (the one-chunk scan), suzanne and suzanne-sub1 (the
culled warp search), with partial warps and dead lanes; K4/K5/K7 per-lane ``acc`` rtol 1e-4 / atol 1e-5 with equal
counts on >= 99 % of lanes; K8's input-state cotangents rtol 1e-3 / atol
1e-5 of the largest on >= 99.9 % of lanes, its material and environment
gradients within 1e-3 of the largest, and bit-identical on a second run.
K4's resident mode (the one-chunk scan on cornell, the culled warp search
on the meshes) and K7 (culled, unpacked) bit for bit against their plain
versions with the cone angles zeroed (the cone sample's sinf/cosf round
unlike torch's), K4 also against the stream mode with the scene's own
materials, with and without tail compaction; K7 also on rays aimed at the
edges two windows share; a ``PackedSceneFused`` raises where the culled
searches need the window boxes, in every K4 mode on the card. K4's replay
mode: ``acc`` and ``cnt``
bit-equal to K4 without it, and on >=
99 % of lanes the plain version's ``acc``/``cnt`` (rtol 1e-4 / atol 1e-5)
and residual slots j < cnt (the same gate). K9: ``d_state0`` within 1e-5 of
its largest on >= 99.9 % of lanes, material and environment gradients within
1e-5 of the largest (the plain version sums in float64), bit-identical on a
second run; the same with the lanes shuffled (counts that differ within
each warp) and some counts set to 0, where d_state0 is the unshuffled run's
bit for bit, permuted, and zero for the emptied lanes, and with a lane
count that is not a multiple of K9's lane groups. K4's stream mode (K6) against the resident K4 bit for bit, with
and without tail compaction and on rays aimed at the edges two windows
share, and against its plain version on >= 99 % of
lanes; K10 against its plain version: bit for bit (state, counts and the
winner record) on a scene without glossy materials, else the same counts,
winners on >= 99.9 % of lanes and states per lane (rtol 1e-4 / atol 1e-5)
on >= 99 % (the cone sample's sinf/cosf round unlike torch.sin/cos); and
bit for bit with the cone angles zeroed on compacted states (live lanes
first, N not a multiple of 32), every lane dead and every lane live, on
cornell, suzanne and suzanne-sub1. K5
(the lane queue; the one-chunk scan, or the culled warp search with the
unpacked winner) bit for bit against its plain version with the cone angles
zeroed, with partial warps, dead first samples and S = 1, 8 and 70; K8 on
warps all hit, all dead and mixed, with the scene's materials and with 40,
bit-identical on a second run, its cot_in at the gates above, d_mat and
d_env within 1e-5 of the largest of the float64 sums. K11 (``rng.uniforms``
on the card) bit for bit against the plain ``rng.uniform``, compared as
int32 or int64 views, in float32 and float64, on the render's keys and the
main path's shapes and at n = 0, 1, 21 and 2^24 + 3; another dtype raises;
one launch a call, its draws counted in ``rng.kernel_draws`` while tracing
is on. K12 (the material gather's VJP) within 1e-5 of the sum of |cot| of
the float64 sums for 1, 4, 101, 340 and 2,000 materials (its slices) over
0, 1, 262,144 and 4,194,304 lanes, bit-identical on a second launch, in
float64 too; a train step launches it once, and two give bit-identical
tables. K13 (the camera stage of a render): the ten state rows and the base
bit for bit the eager stage's on the card, on cornell through its lens and
its pinhole, suzanne and bbc-owl, with and without the glossy cone and the
kill, on a tile whose pixels and lanes are no multiple of the block; so is
regen_front's state0 and base sum against the eager stages'; a render
launches K13a and K13b once each a stage, K2 once and K11 twice, and counts
its stages in ``k13.stages``; a train step launches no K13; a cornell 64^2
render equals the same render with every stage eager, bit for bit.
"""

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.render import render
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
from pt_three_ways_tpu_torch.ops import camera_kernel as ck
from pt_three_ways_tpu_torch.ops import intersect_kernel as ik
from pt_three_ways_tpu_torch.ops import kernel_rng, rng
from pt_three_ways_tpu_torch.ops import material_grad as mg
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.utils import tracing
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _state(name, dev, w=32, s_count=3):
    params = RenderParams(width=w, height=w, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=4)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params).to(dev)
    scene = sb.build(device=dev)
    n = w * w
    px = torch.arange(n, dtype=torch.int32, device=dev) % w
    py = torch.arange(n, dtype=torch.int32, device=dev) // w
    states, unifs = [], []
    for s in range(s_count):
        key = rng.fold_in(rng.fold_in(rng.base_key(1), s), 0)
        st, _, un = integ._first_bounce_state(scene, camera, params, key, px, py,
                                              1024, "kernel")
        states.append(st)
        unifs.append(un)
    lanes = integ.lane_ids_for(px, py, w, 4)
    return scene, torch.cat(states), torch.cat(unifs), lanes


def edge_rays(scene, window, seed=3):
    """Rays aimed at both ends and the midpoint of every edge shared by two
    triangles of different windows, from origins 0.2-2 units away in random
    directions: (org [3, R], dirn [3, R], the pair's triangle ids [2, R])."""
    verts = scene.triangles.verts.numpy().astype(np.float32)
    owner = {}
    pairs = []
    for i, tri in enumerate(verts):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(tri[a]), tuple(tri[b]))))
            j = owner.setdefault(key, i)
            if j != i and j // window != i // window:
                pairs.append((j, i, tri[a], tri[b]))
    rs = np.random.default_rng(seed)
    org, dirn, ids = [], [], []
    for j, i, p, q in pairs:
        for target in (p, q, (p + q) * np.float32(0.5)):
            for _ in range(4):
                off = rs.normal(size=3)
                o = target + off / np.linalg.norm(off) * rs.uniform(0.2, 2.0)
                d = target - o
                org.append(o)
                dirn.append(d / np.linalg.norm(d))
                ids.append((j, i))
    as_t = lambda x, dt: torch.from_numpy(np.asarray(x, dtype=dt).T.copy())
    return as_t(org, np.float32), as_t(dirn, np.float32), as_t(ids, np.int32)


def _lanes_agree(a, b):
    (acc_k, cnt_k), (acc_p, cnt_p) = a, b
    ok = torch.all(torch.isclose(acc_k, acc_p, rtol=1e-4, atol=1e-5), dim=0) & (cnt_k == cnt_p)
    return ok.float().mean().item()


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_kernels_match_plain_versions(dev, name):
    scene, state0, unif, lanes = _state(name, dev)
    pk = mk.PackedSceneStream(scene)  # K4's culled search reads its window boxes
    org = state0[0:3].contiguous()
    dirn = state0[3:6].contiguous()
    live = state0[9] != 0
    t_k, i_k = ik.intersect_packed(pk, org, dirn, 1e-4, live=live)
    t_p, i_p = ik.intersect_plain(pk, org, dirn, live, 1e-4)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    nexta = mk.next_alive_table(state0, 3)
    table = mk.lane_major_table(unif, 3, 3)
    k5 = mk.fused_passes(pk, state0, table, 1e-4, 3, 3)
    p5 = mk.fused_passes_plain(pk, state0, nexta, table, 1e-4, 3, 3)
    assert _lanes_agree(k5, p5) >= 0.99
    seeds = kernel_rng.channel_seeds(5, 6)
    amask = mk.alive_mask_words(state0, 3)
    k4 = mk.fused_passes_krng(pk, state0, lanes, (5, 6), 0, 1e-4, 3, 3)
    p4 = mk.regen_krng_plain(pk, lanes, amask, state0, None, seeds, 0, 1e-4, 3, 3,
                             0, pk.no_glossy)[:2]
    assert _lanes_agree(k4, p4) >= 0.99
    tail = mk.fused_passes_krng(pk, state0, lanes, (5, 6), 0, 1e-4, 3, 3, tail_frac=0.125)
    assert torch.equal(tail[1], k4[1])
    torch.testing.assert_close(tail[0], k4[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["cornell", "suzanne", "suzanne-sub1"])
def test_k2_matches_plain_bitwise(dev, name):
    """K2 (the one-chunk scan on cornell, the culled warp search on the
    meshes) against its plain version, bit for bit, on the camera rays and
    the first bounce's rays of a 31^2 image (R not a multiple of 32: the
    last warp partial) with a tenth of the lanes dead."""
    params = RenderParams(width=31, height=31)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params).to(dev)
    scene = sb.build(device=dev)
    n = 31 * 31
    px = torch.arange(n, dtype=torch.int32, device=dev) % 31
    py = torch.arange(n, dtype=torch.int32, device=dev) // 31
    u = rng.uniforms(rng.stream_key(rng.base_key(3), rng.CAMERA_STREAM), (4, n), dev)
    from pt_three_ways_tpu_torch.ops.camera import generate_rays

    org0, dir0 = generate_rays(camera, px, py, u)
    st, _, _ = integ._first_bounce_state(scene, camera, params, rng.base_key(3), px, py, 1024,
                                         "kernel")
    org = torch.cat([org0, st[0:3]], dim=1)[:, :2 * n - 5].contiguous()
    dirn = torch.cat([dir0, st[3:6]], dim=1)[:, :2 * n - 5].contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    live = torch.rand((org.shape[1],), generator=gen, device=dev) > 0.1
    assert org.shape[1] % 32 and not live.all()
    for pk in (ik.PackedScene(scene), mk.PackedSceneStream(scene)):
        t_k, i_k = ik.intersect_packed(pk, org, dirn, 1e-4, live=live)
        t_p, i_p = ik.intersect_plain(pk, org, dirn, live, 1e-4)
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
        assert torch.isinf(t_k[~live]).all() and (i_k[~live] == 0).all()
        assert torch.isfinite(t_k).float().mean().item() > 0.3


@pytest.mark.parametrize("name", ["cornell", "suzanne", "ce", "single-sphere",
                                  "multi-sphere", "example1", "bbc-owl"])
def test_card_render_matches_cpu_scan_wavefront(dev, name):
    """Table-RNG regen on the card (K2 + K5) against the CPU scan wavefront:
    the same draws, so >= 99 % of pixels agree to 2e-4."""
    params = RenderParams(width=16, height=16, samples_per_pixel=2, seed=4,
                          first_bounce_u_samples=2, first_bounce_v_samples=2,
                          max_depth=4, rng_mode="table", passes_per_dispatch=2)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, camera))  # as the CLI
    gpu = render(scene, camera, params, device="cuda").mean()
    cpu = render(scene, camera, params, device="cpu").mean()
    ok = (abs(gpu - cpu) <= 2e-4 + 2e-4 * abs(cpu)).all(axis=2)
    assert ok.mean() >= 0.99, ok.mean()


@pytest.mark.parametrize("name", ["cornell", "suzanne", "example1"])
def test_training_kernels_match_plain_versions(dev, name):
    scene, state0, unif, _ = _state(name, dev, s_count=1)
    pk = mk.PackedSceneStream(scene)  # K7's culled search reads its window boxes
    nb = 3
    a = (pk, state0[0:3], state0[3:6], state0[6:9], state0[9] != 0, unif, 1e-4, nb)
    k7 = mk.fused_bounces(*a, with_residuals=True)
    p7 = mk.fused_bounces_plain(pk, *(x.contiguous() for x in a[1:6]), 1e-4, nb, True)
    assert _lanes_agree(k7[:2], p7[:2]) >= 0.99
    assert (k7[4] == p7[4]).float().mean().item() >= 0.99
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in range(nb):
        args = (pk, k7[2][13 * d:13 * d + 13], k7[3][d], k7[4][d], unif[4 * d:4 * d + 4],
                torch.randn((13, state0.shape[1]), generator=gen, device=dev))
        o1 = mk.bounce_bwd_step(*args)
        o2 = mk.bounce_bwd_step(*args)
        op = mk.bounce_bwd_plain(*(x.contiguous() if torch.is_tensor(x) else x for x in args))
        assert all(torch.equal(x, y) for x, y in zip(o1, o2))
        scale = op[0].abs().max()
        lanes = torch.all(torch.isclose(o1[0], op[0], rtol=1e-3, atol=1e-5 * scale), dim=0)
        assert lanes.float().mean().item() >= 0.999
        for got, ref in zip(o1[1:], op[1:]):
            assert (got - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-6


def test_train_step_on_card_matches_cpu(dev):
    """One replay train step (K2, K7, K8 on the card) against the same step
    on the CPU (plain versions): loss rtol 1e-4, each material update within
    1e-3 of the field's largest (ior 1e-2: rounding noise at ior 1)."""
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    params = RenderParams(width=16, height=16, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=4, intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    px = torch.arange(256, dtype=torch.int32) % 16
    py = torch.arange(256, dtype=torch.int32) // 16
    target = torch.full((256, 3), 0.25)
    out = {}
    for where in ("cuda", "cpu"):
        step = make_sharded_train_step(scene, params, device=where)
        out[where] = step(TrainState(scene.materials, camera, 0), rng.base_key(2), px, py, target)
    (lc, sc), (lh, sh) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lh)) <= 1e-4 * abs(float(lh))
    for f, c, h, o in zip(sh.materials._fields, sc.materials, sh.materials, scene.materials):
        tol = 1e-2 if f == "ior" else 1e-3
        assert (c.cpu() - h).abs().max() <= tol * (h - o).abs().max() + 1e-9, f


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_regen_replay_kernels_match_plain_versions(dev, name):
    scene, state0, _, lanes = _state(name, dev)
    pk = mk.PackedSceneStream(scene, window=64)  # the replay's culling boxes
    nb, s_count = 3, 3
    a = (pk, state0, lanes, (5, 6), 0, 1e-4, nb, s_count)
    acc, cnt, res = mk.fused_passes_krng(*a, replay=True)
    assert all(torch.equal(x, y) for x, y in zip((acc, cnt), mk.fused_passes_krng(*a)))
    seeds = kernel_rng.channel_seeds(5, 6)
    amask = mk.alive_mask_words(state0, s_count)
    pres = torch.zeros_like(res)
    pacc, pcnt, _ = mk.regen_krng_plain(pk, lanes, amask, state0, None, seeds, 0, 1e-4,
                                        nb, s_count, 0, pk.no_glossy, rres=pres)
    real = (torch.arange(s_count * nb, device=dev)[:, None] < cnt[None, :])[:, None, :]
    same = torch.isclose(res, pres, rtol=1e-4, atol=1e-5) | ~real
    lanes_ok = (torch.all(torch.isclose(acc, pacc, rtol=1e-4, atol=1e-5), dim=0)
                & (cnt == pcnt) & same.all(dim=0).all(dim=0))
    assert lanes_ok.float().mean().item() >= 0.99
    gen = torch.Generator(device=dev).manual_seed(0)
    acc_bar = torch.randn((3, state0.shape[1]), generator=gen, device=dev)
    b = (pk, lanes, (5, 6), 0, res, cnt, acc_bar, s_count)
    o1 = mk.regen_replay_bwd(*b)
    o2 = mk.regen_replay_bwd(*b)
    op = mk.regen_replay_bwd_plain(pk, lanes, res, cnt, acc_bar, seeds, 0, s_count)
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    scale = op[0].abs().max()
    d0_ok = torch.all(torch.isclose(o1[0], op[0], rtol=0, atol=1e-5 * scale), dim=0)
    assert d0_ok.float().mean().item() >= 0.999
    for got, ref in zip(o1[1:], op[1:]):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max() + 1e-9
    with pytest.raises(ValueError):  # the card's replay needs the boxes
        mk.fused_passes_krng(mk.PackedSceneFused(scene), *a[1:], replay=True)


def test_k9_unsorted_lanes_and_empty_lanes(dev):
    """K9 on cornell (five materials) with its lanes shuffled and every
    seventh lane's count set to 0 (and the last three lanes cut, so the lane
    count is not a multiple of K9's groups): against its plain version at
    the gates above, bit-identical on a second run, d_state0 the unshuffled
    run's bit for bit and zero for the emptied lanes."""
    scene, state0, _, lanes = _state("cornell", dev)
    pk = mk.PackedSceneStream(scene)
    nb, s_count = 3, 3
    _, cnt, res = mk.fused_passes_krng(pk, state0, lanes, (5, 6), 0, 1e-4, nb, s_count,
                                       replay=True)
    n = cnt.shape[0] - 3
    gen = torch.Generator(device=dev).manual_seed(2)
    perm = torch.randperm(n, generator=gen, device=dev)
    cnt = cnt[:n].clone()
    cnt[::7] = 0
    acc_bar = torch.randn((3, n), generator=gen, device=dev)
    res, lanes = res[:, :, :n], lanes[:n]
    base = mk.regen_replay_bwd(pk, lanes, (5, 6), 0, res.contiguous(), cnt, acc_bar, s_count)
    b = (pk, lanes[perm], (5, 6), 0, res[:, :, perm].contiguous(), cnt[perm],
         acc_bar[:, perm].contiguous(), s_count)
    assert any(len(set(c.tolist())) > 1 for c in b[5][:n // 32 * 32].reshape(-1, 32))
    o1 = mk.regen_replay_bwd(*b)
    o2 = mk.regen_replay_bwd(*b)
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    assert torch.equal(o1[0], base[0][:, perm])
    assert not base[0][:, ::7].any()
    seeds = kernel_rng.channel_seeds(5, 6)
    op = mk.regen_replay_bwd_plain(pk, *b[1:2], b[4], b[5], b[6], seeds, 0, s_count)
    scale = op[0].abs().max()
    d0_ok = torch.all(torch.isclose(o1[0], op[0], rtol=0, atol=1e-5 * scale), dim=0)
    assert d0_ok.float().mean().item() >= 0.999
    for got, ref in zip(o1[1:], op[1:]):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max() + 1e-9


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_stream_matches_resident_bitwise(dev, name):
    scene, state0, _, lanes = _state(name, dev)
    ps = mk.PackedSceneStream(scene, window=64)
    pk = ps
    a = (state0, lanes, (5, 6), 0, 1e-4, 3, 3)
    for tail in (0.0, 0.125):
        res = mk.fused_passes_krng(pk, *a, tail_frac=tail)
        launches = mk.fused_passes_krng.stream_launches
        stm = mk.fused_passes_krng(ps, *a, tail_frac=tail, stream=True)
        assert mk.fused_passes_krng.stream_launches > launches
        assert torch.equal(stm[0], res[0]) and torch.equal(stm[1], res[1])
    seeds = kernel_rng.channel_seeds(5, 6)
    amask = mk.alive_mask_words(state0, 3)
    p4 = mk.regen_krng_plain(ps, lanes, amask, state0, None, seeds, 0, 1e-4, 3, 3, 0,
                             ps.no_glossy, stream=True)[:2]
    assert _lanes_agree(stm, p4) >= 0.99


@pytest.mark.parametrize("window", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("fan", [1, 8])
def test_stream_designs_match_resident_bitwise(dev, fan, window):
    """K6 at every window size (1 to 16 chunks a window; 1024 rows take
    more than 48 KB of shared memory) and without (fan 1) or with level-1
    boxes gives the resident K4's acc and counts bit for bit, with and
    without tail compaction, on suzanne-sub1."""
    scene, state0, _, lanes = _state("suzanne-sub1", dev, w=48, s_count=2)
    a = (state0, lanes, (5, 6), 0, 1e-4, 3, 2)
    pk = mk.PackedSceneStream(scene)  # the resident K4's culled search: 64-row windows
    ps = mk.PackedSceneStream(scene, window=window, fan=fan)
    for tail in (0.0, 0.125):
        res = mk.fused_passes_krng(pk, *a, tail_frac=tail)
        stm = mk.fused_passes_krng(ps, *a, tail_frac=tail, stream=True)
        assert torch.equal(stm[0], res[0]) and torch.equal(stm[1], res[1])


@pytest.mark.parametrize("name", ["suzanne-sub1", "suzanne-sub2"])
def test_stream_matches_resident_on_edges_shared_between_windows(dev, name):
    """K4 streamed and resident on rays aimed at the edges two windows share
    (one sample, unit throughput): bit-equal acc and counts."""
    params = RenderParams(width=8, height=8)
    sb = SceneBuilder()
    create_scene(sb, name, params)
    scene = sb.build()
    org, dirn, _ = edge_rays(scene, 64)
    n = org.shape[1]
    state0 = torch.cat([org, dirn, torch.ones((4, n))]).to(dev)
    scene = scene.to(dev)
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    a = (state0, lanes, (5, 6), 0, 1e-4, 3, 1)
    ps = mk.PackedSceneStream(scene, window=64)
    res = mk.fused_passes_krng(ps, *a)
    stm = mk.fused_passes_krng(ps, *a, stream=True)
    assert torch.equal(stm[0], res[0]) and torch.equal(stm[1], res[1])
    assert int(res[1].sum()) > n


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_bounce_step_matches_plain_version(dev, name):
    scene, state0, unif, _ = _state(name, dev, s_count=1)
    pk = mk.PackedSceneFused(scene)
    state = torch.cat([state0, torch.rand((3, state0.shape[1]), device=dev)])
    state[9, ::3] = 0.0
    for d in range(3):
        un = unif[4 * d:4 * d + 4].contiguous()
        k10 = mk.bounce_step(pk, state, un, 1e-4, with_hit=True)
        p10 = mk.bounce_step_plain(pk, state, un, 1e-4, with_hit=True)
        if pk.no_glossy:
            assert all(torch.equal(x, y) for x, y in zip(k10, p10))
        else:
            assert torch.equal(k10[1], p10[1])
            assert (k10[3] == p10[3]).float().mean().item() >= 0.999
            ok = torch.all(torch.isclose(k10[0], p10[0], rtol=1e-4, atol=1e-5), dim=0)
            assert ok.float().mean().item() >= 0.99
        assert all(torch.equal(x, y) for x, y in zip(mk.bounce_step(pk, state, un, 1e-4), k10))
        state = k10[0]


def _no_glossy(scene):
    m = scene.materials
    return scene._replace(materials=m._replace(cone_angle=torch.zeros_like(m.cone_angle)))


def _live_first(state):
    """The stable partition of trace_passes_compact: live lanes first."""
    return state[:, torch.argsort((state[9] == 0.0).to(torch.int32), stable=True)]


@pytest.mark.parametrize("layout", ["compacted", "all-dead", "all-live"])
@pytest.mark.parametrize("n_cut", [37, 36])
@pytest.mark.parametrize("name", ["cornell", "suzanne", "suzanne-sub1"])
def test_k10_compacted_state_matches_plain_bitwise(dev, name, n_cut, layout):
    """K10 on the states of the compacting wavefront (live lanes first, a
    dead tail whose wholly dead warps skip the search) with the cone angles
    zeroed: state, counts, t and idx bit-equal to ``bounce_step_plain``, with
    and without the record, over three bounces, on the one-chunk scan
    (cornell) and the culled warp search (suzanne; suzanne-sub1, several
    windows and level-1 boxes); N is not a multiple of 32 or 128 (odd, and
    a multiple of 4); every lane dead; every lane live."""
    scene, state0, unif, _ = _state(name, dev, s_count=1)
    n = state0.shape[1] - n_cut
    pk = mk.PackedSceneFused(_no_glossy(scene))
    acc = torch.from_numpy(np.random.default_rng(2).uniform(size=(3, n)).astype(np.float32))
    state = torch.cat([state0[:, :n], acc.to(dev)])
    unif = unif[:, :n]
    if layout == "all-dead":
        state[9] = 0.0
    if layout == "all-live":
        keep = state[9] != 0.0
        state, unif = state[:, keep], unif[:, keep]
    n_live = int((state[9] != 0).sum())
    assert n % 32 and (layout == "all-dead") == (n_live == 0)
    assert layout != "all-live" or n_live == state.shape[1]
    for d in range(3):
        state = _live_first(state).contiguous()
        un = unif[4 * d:4 * d + 4].contiguous()
        k10 = mk.bounce_step(pk, state, un, 1e-4, with_hit=True)
        p10 = mk.bounce_step_plain(pk, state, un, 1e-4, with_hit=True)
        assert all(torch.equal(x, y) for x, y in zip(k10, p10))
        assert all(torch.equal(x, y) for x, y in zip(mk.bounce_step(pk, state, un, 1e-4), k10))
        state = k10[0]


@pytest.mark.parametrize("tail_frac", [0.0, 0.125])
@pytest.mark.parametrize("name", ["cornell", "suzanne", "suzanne-sub1"])
def test_resident_k4_matches_plain_and_stream_bitwise(dev, monkeypatch, name, tail_frac):
    """K4's resident mode: its one-chunk scan (cornell) or culled warp search
    (the meshes) gives acc and counts bit-equal to the stream mode (K6)
    with the scene's own materials and to its plain version with the cone
    angles zeroed, with and without tail compaction; a ``PackedSceneFused``
    raises (the card's K4 takes a ``PackedSceneStream``)."""
    scene, state0, _, lanes = _state(name, dev)
    a = (state0, lanes, (5, 6), 0, 1e-4, 3, 3)
    ps = mk.PackedSceneStream(scene)
    res = mk.fused_passes_krng(ps, *a, tail_frac=tail_frac)
    stm = mk.fused_passes_krng(ps, *a, tail_frac=tail_frac, stream=True)
    assert torch.equal(stm[0], res[0]) and torch.equal(stm[1], res[1])
    pn = mk.PackedSceneStream(_no_glossy(scene))
    kern = mk.fused_passes_krng(pn, *a, tail_frac=tail_frac)
    monkeypatch.setattr(mk, "_regen_krng_cuda", mk.regen_krng_plain)
    plain = mk.fused_passes_krng(pn, *a, tail_frac=tail_frac)
    monkeypatch.undo()
    assert int(kern[1].sum()) > 0
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])
    with pytest.raises(ValueError):
        mk.fused_passes_krng(mk.PackedSceneFused(scene), *a, tail_frac=tail_frac)


@pytest.mark.parametrize("name", ["cornell", "suzanne", "suzanne-edges"])
def test_culled_k7_matches_plain_bitwise(dev, name):
    """K7's culled warp search (unpacked winner) with its residuals: acc,
    counts, states, t and idx bit-equal to ``fused_bounces_plain`` (which
    scans every triangle) with the cone angles zeroed, on the camera
    stage's first-bounce states and on rays aimed at the edges two windows
    share; a ``PackedSceneFused`` raises."""
    nb = 3
    if name == "suzanne-edges":
        params = RenderParams(width=8, height=8)
        sb = SceneBuilder()
        create_scene(sb, "suzanne", params)
        scene = sb.build()
        org, dirn, _ = edge_rays(scene, 64)
        n = org.shape[1]
        gen = np.random.default_rng(4)
        unif = torch.from_numpy(gen.uniform(size=(4 * nb, n)).astype(np.float32)).to(dev)
        st = torch.cat([org, dirn, torch.ones((4, n))]).to(dev)
        scene = scene.to(dev)
    else:
        scene, st, unif, _ = _state(name, dev, s_count=1)
    ps = mk.PackedSceneStream(_no_glossy(scene))
    a = (st[0:3].contiguous(), st[3:6].contiguous(), st[6:9].contiguous(), st[9] != 0,
         unif.contiguous())
    kern = mk.fused_bounces(ps, *a, 1e-4, nb, with_residuals=True)
    plain = mk.fused_bounces_plain(ps, *a, 1e-4, nb, True)
    assert int(kern[1].sum()) > 0
    assert all(torch.equal(x, y) for x, y in zip(kern, plain))
    assert all(torch.equal(x, y) for x, y in zip(mk.fused_bounces(ps, *a, 1e-4, nb), plain))
    with pytest.raises(ValueError):
        mk.fused_bounces(mk.PackedSceneFused(scene), *a, 1e-4, nb)


def _table_inputs(name, dev, s_count, w=8):
    """K5's inputs with the awkward lanes: the camera stage's first-bounce
    state and uniform tables for ``s_count`` samples on a w x w frame (4
    lanes a pixel), cut to a lane count that is not a multiple of the block
    (partial warps), every third lane's first sample and every seventh
    lane's every sample dead."""
    scene, state0, unif, _ = _state(name, dev, w=w, s_count=s_count)
    n = state0.shape[1] - 37
    state0, unif = state0[:, :n].clone(), unif[:, :n].contiguous()
    state0[9, ::3] = 0.0
    state0[9::10, ::7] = 0.0
    return scene, state0.contiguous(), unif


@pytest.mark.parametrize("s_count", [1, 8, 70])
@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_k5_matches_plain_bitwise(dev, name, s_count):
    """K5 (the lane queue; the one-chunk scan on cornell, the culled warp
    search with the unpacked winner on suzanne): acc and counts bit-equal to
    ``fused_passes_plain`` with the cone angles zeroed, with partial warps,
    lanes whose first samples are dead, and S = 1, 8 and 70 (the
    next-alive table takes any S, beyond K4's 64); a ``PackedSceneFused``
    raises (its culled search reads a ``PackedSceneStream``'s boxes)."""
    nb = 3
    scene, state0, unif = _table_inputs(name, dev, s_count)
    unif = mk.lane_major_table(unif, nb, s_count)
    ps = mk.PackedSceneStream(_no_glossy(scene))
    kern = mk.fused_passes(ps, state0, unif, 1e-4, nb, s_count)
    plain = mk.fused_passes_plain(ps, state0, mk.next_alive_table(state0, s_count), unif, 1e-4,
                                  nb, s_count)
    assert int(kern[1].sum()) > 0 and int((kern[1] == 0).sum()) > 0
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])
    with pytest.raises(ValueError):
        mk.fused_passes(mk.PackedSceneFused(scene), state0, unif, 1e-4, nb, s_count)


def _many_materials(scene, pk, n_mat=40, seed=5):
    """``pk`` with its primitives spread over ``n_mat`` materials (the
    scene's repeated), each primitive's at random."""
    gen = torch.Generator().manual_seed(seed)
    m = scene.materials
    reps = -(-n_mat // m.emission.shape[0])
    mats = type(m)(*(torch.cat([f.cpu()] * reps)[:n_mat] for f in m))
    pk.tri_mat = torch.randint(0, n_mat, pk.tri_mat.shape, generator=gen,
                               dtype=torch.int32).to(pk.tri_mat.device)
    pk.sph_mat = torch.randint(0, n_mat, pk.sph_mat.shape, generator=gen,
                               dtype=torch.int32).to(pk.sph_mat.device)
    return pk.with_materials(type(m)(*(f.to(pk.tri_mat.device) for f in mats)),
                             scene.environment)


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_k8_lane_classes_match_plain(dev, name, many):
    """K8 on lanes arranged in warps all hit, all dead and mixed (the camera
    stage's first-bounce states, then three warps of hit lanes, three of
    dead ones and the rest as they come), a lane count that is not a
    multiple of 128, with the scene's materials or 40 (more than a warp's
    lanes): bit-identical on a second run, cot_in within today's gates of
    ``bounce_bwd_plain`` (rtol 1e-3 / atol 1e-5 of the largest on >= 99.9 %
    of lanes), d_mat and d_env within 1e-5 of the largest of its float64
    sums."""
    scene, state0, unif, _ = _state(name, dev, w=24, s_count=1)
    pk = mk.PackedSceneStream(scene)
    if many:
        pk = _many_materials(scene, pk)
    live = state0[9] != 0
    t, idx = ik.intersect_packed(pk, state0[0:3].contiguous(), state0[3:6].contiguous(), 1e-4,
                                 live=live)
    hit = live & torch.isfinite(t)
    hits = torch.nonzero(hit).flatten()
    rest = torch.nonzero(~hit).flatten()
    assert hits.numel() >= 96 + 200
    order = torch.cat([hits[:96], rest[:96], hits[96:], rest[96:]])
    n = order.numel() - 21
    order = order[:n]
    state = torch.cat([state0[:10], torch.rand((3, state0.shape[1]), device=dev)])[:, order]
    state[9, 96:192] = 0.0  # three warps of dead lanes
    gen = torch.Generator(device=dev).manual_seed(1)
    args = (pk, state.contiguous(), t[order].contiguous(), idx[order].contiguous(),
            unif[0:4, order].contiguous(),
            torch.randn((13, n), generator=gen, device=dev))
    o1 = mk.bounce_bwd_step(*args)
    o2 = mk.bounce_bwd_step(*args)
    op = mk.bounce_bwd_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    assert pk.n_mat == (40 if many else scene.materials.emission.shape[0])
    scale = op[0].abs().max()
    lanes = torch.all(torch.isclose(o1[0], op[0], rtol=1e-3, atol=1e-5 * scale), dim=0)
    assert lanes.float().mean().item() >= 0.999
    assert torch.equal(o1[0][:, 96:192], torch.cat([args[5][:9, 96:192],
                                                    torch.zeros((1, 96), device=dev),
                                                    args[5][10:, 96:192]]))
    for got, ref in zip(o1[1:], op[1:]):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert int((op[1].abs().sum(dim=1) > 0).sum()) > (10 if many else 0)


def _k11_keys():
    """The render's key chain (``fold_in(fold_in(base, sample), tile)``) on
    the camera, first-bounce and a bounce stream, and a 64-bit seed."""
    key = rng.fold_in(rng.fold_in(rng.base_key(1234567), 5), 2)
    return [rng.stream_key(key, rng.CAMERA_STREAM), rng.stream_key(key, rng.FIRST_BOUNCE_STREAM),
            rng.fold_in(rng.stream_key(key, rng.BOUNCE_STREAM_BASE), 3),
            rng.PRNGKey(2**32 + 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(4, 414720), (3, 414720, 16), (3, 4194304), (0,), (1,),
                                   (3, 7), (2**24 + 3,)])
def test_k11_uniforms_match_plain_bitwise(dev, shape, dtype):
    """K11 (the camera stage's threefry) equals the plain int64 version bit
    for bit: the main path's shapes (cornell's camera and first-bounce
    draws, a training pass's bounce rows), no element, one, a count that is
    not a multiple of a thread's four and one past 2^24."""
    view = torch.int32 if dtype == torch.float32 else torch.int64
    for key in _k11_keys():
        got = rng.uniforms(key, shape, dev, dtype)
        ref = rng.uniform(key, shape, dev, dtype)
        assert got.shape == ref.shape and got.dtype == dtype and got.device == ref.device
        assert torch.equal(got.view(view), ref.view(view))


def test_k11_launches_and_dtypes(dev):
    """One launch a call, the draws counted while tracing is on; a dtype
    the kernel does not make raises."""
    key = _k11_keys()[0]
    before = rng.uniform_kernel.launches
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("pt3.render"):
            rng.uniforms(key, (4, 1000), dev)
            rng.uniforms(key, (3, 5), dev, torch.float64)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    assert rng.uniform_kernel.launches == before + 2
    assert counters["rng.kernel_draws"] == 4015
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="unsupported dtype"):
            rng.uniforms(key, (8,), dev, dtype)
    assert rng.uniform_kernel.launches == before + 2


def _k12_inputs(n_mat, n, dev, dtype=torch.float32, seed=5):
    """ids [n] int32 in runs of one material (as neighbouring pixels hit)
    for the first half, at random after; material n_mat // 2 in no lane
    where there is more than one. cot [9, n] normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.arange(n_mat, device=dev)
    if n_mat > 1:
        pool = pool[pool != n_mat // 2]
    pick = lambda k: pool[torch.randint(0, pool.numel(), (k,), generator=gen, device=dev)]
    n_runs = n // 100 + 1
    runs = torch.repeat_interleave(pick(n_runs), torch.randint(
        1, 200, (n_runs,), generator=gen, device=dev))[:n // 2]
    ids = torch.cat([runs, pick(n - runs.numel())]).to(torch.int32).contiguous()
    cot = torch.randn((9, n), generator=gen, device=dev, dtype=dtype)
    return ids, cot


@pytest.mark.parametrize("n", [0, 1, 262144, 4194304])
@pytest.mark.parametrize("n_mat", [1, 4, 101, 340, 2000])
def test_k12_matches_plain_and_float64_sums(dev, n_mat, n):
    """K12 against its plain version (a lane-order index_add_) and the
    float64 sum: each entry within 1e-5 of the sum of its lanes' |cot|.
    Why 1e-5: K12 adds a lane through at most ~60 roundings (a thread's
    running sum over its <= 16 tiles, the warp's 5 shuffles, up to 16
    flushes into the warp's row, 8 warps, the second pass over <= 1024
    blocks: 4 strided and 8 tree levels), each within 2^-24 of a partial
    sum, so at most ~4e-6 of the sum of |cot|.
    The plain version sums in lane order and may stray further: it is held
    to the float64 sum by its own distance plus K12's limit. Two launches
    are bit-identical; 2000 materials take K12's slices (more rows than a
    block's shared memory holds at once); material n_mat // 2 is in no
    lane and reads exactly 0."""
    ids, cot = _k12_inputs(n_mat, n, dev)
    before = mg.material_grad.launches
    got = mg.material_grad(ids, cot, n_mat)
    again = mg.material_grad(ids, cot, n_mat)
    assert mg.material_grad.launches == before + 2
    assert got.shape == (n_mat, 9) and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got, again)
    plain = mg.material_grad_plain(ids, cot, n_mat)
    ids64 = ids.long()
    ref = torch.zeros((n_mat, 9), dtype=torch.float64, device=dev)
    ref.index_add_(0, ids64, cot.T.double())
    scale = torch.zeros_like(ref).index_add_(0, ids64, cot.T.double().abs())
    err = (got.double() - ref).abs()
    assert (err <= 1e-5 * scale).all(), float((err / scale.clamp(min=1e-30)).max())
    assert ((got.double() - plain.double()).abs()
            <= (plain.double() - ref).abs() + 1e-5 * scale).all()
    if n_mat > 1:
        assert float(got[n_mat // 2].abs().max()) == 0.0


def test_k12_float64_and_refusals(dev):
    """K12 in float64 (the table chip_smoke's float64 lane sums gather
    from) within 1e-12 of the sum of |cot| of its plain version; the
    wrapper refuses other shapes and types before any launch."""
    ids, cot = _k12_inputs(5, 100000, dev, torch.float64)
    got = mg.material_grad(ids, cot, 5)
    plain = mg.material_grad_plain(ids, cot, 5)
    scale = torch.zeros_like(plain).index_add_(0, ids.long(), cot.T.abs())
    assert got.dtype == torch.float64 and torch.equal(got, mg.material_grad(ids, cot, 5))
    assert ((got - plain).abs() <= 1e-12 * scale).all()
    before = mg.material_grad.launches
    for bad in ((ids.long(), cot), (ids, cot.half()), (ids, cot[:, :-1]),
                (ids.cpu(), cot), (ids, cot.T.contiguous().T)):
        with pytest.raises(ValueError):
            mg.material_grad(*bad, 5)
    assert mg.material_grad.launches == before


def test_k12_is_the_train_steps_material_gather_vjp(dev):
    """A train step of test_train_step_on_card_matches_cpu's shape launches
    K12 once (its one camera stage) and no PyTorch index backward (the
    kernels of the backward, by torch.profiler, where it sees the card);
    two identical steps give bit-identical material tables."""
    from torch.profiler import ProfilerActivity, profile

    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    params = RenderParams(width=16, height=16, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=4, intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    px = torch.arange(256, dtype=torch.int32) % 16
    py = torch.arange(256, dtype=torch.int32) // 16
    target = torch.full((256, 3), 0.25)
    step = make_sharded_train_step(scene, params, device="cuda")
    state = TrainState(scene.materials, camera, 0)
    before = mg.material_grad.launches
    _, s1 = step(state, rng.base_key(2), px, py, target)
    assert mg.material_grad.launches == before + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, s2 = step(state, rng.base_key(2), px, py, target)
        torch.cuda.synchronize()
    assert mg.material_grad.launches == before + 2
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert not any("indexing_backward" in k or "index_put" in k for k in names), names
    assert all(torch.equal(a, b) for a, b in zip(s1.materials, s2.materials))


def _k13_tile(name, dev, lens=True, w=48, h=37):
    """A ragged tile (R = w*h - 5, not a multiple of K13's 256-thread
    blocks, nor R*K) of ``name`` on the card with its pack; ``lens=False``
    sets the aperture to 0 (the pinhole path)."""
    params = RenderParams(width=w, height=h, max_depth=4, seed=3)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, camera))
    if not lens:
        camera = camera._replace(aperture=torch.zeros_like(camera.aperture))
    scene, camera = scene.to(dev), camera.to(dev)
    r = w * h - 5
    px = torch.arange(r, dtype=torch.int32, device=dev) % w
    py = torch.arange(r, dtype=torch.int32, device=dev) // w
    return scene, camera, params, px, py, mk.PackedSceneStream(scene)


def _ulp_gaps(a, b):
    """Per row, the largest distance in float32 steps between a and b."""
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return (ai - bi).abs().amax(dim=-1).tolist()


@pytest.mark.parametrize("kill_dead", [True, False])
@pytest.mark.parametrize("no_glossy", [False, True])
@pytest.mark.parametrize("name, lens", [("cornell", True), ("cornell", False),
                                        ("suzanne", True), ("bbc-owl", True)])
def test_k13_matches_eager_stage_bitwise(dev, name, lens, no_glossy, kill_dead):
    """The camera stage as K13 (a render's: float32, the kernel backend, a
    PackedSceneFused, nothing differentiated) against the eager stage, its
    plain version, on the card: the ten state rows and the base bit for bit,
    on cornell's glossy sphere through its lens and its pinhole, suzanne's
    mesh and the owl's Fresnel spheres (aperture 0.1)."""
    scene, camera, params, px, py, pk = _k13_tile(name, dev, lens)
    key = rng.fold_in(rng.fold_in(rng.base_key(2 ** 33 + 19), 3), 1)
    before = (ck.camera_rays.launches, ck.first_bounce.launches)
    with torch.no_grad():
        rows, base, _ = integ._first_bounce_state(scene, camera, params, key, px, py, 1024,
                                                  "kernel", want_unif=False, packed=pk,
                                                  no_glossy=no_glossy, kill_dead=kill_dead)
        e_rows, e_base = integ._first_bounce_eager(scene, camera, params, key, px, py, 1024,
                                                   "kernel", pk, no_glossy, kill_dead)
    assert (ck.camera_rays.launches, ck.first_bounce.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    assert rows.shape == e_rows.shape and rows.dtype == torch.float32
    assert torch.equal(rows.view(torch.int32), e_rows.contiguous().view(torch.int32)), \
        f"rows' ulp gaps {_ulp_gaps(rows, e_rows)}"
    assert torch.equal(base.view(torch.int32), e_base.contiguous().view(torch.int32)), \
        f"base's ulp gaps {_ulp_gaps(base, e_base)}"
    assert 0.1 < float(rows[9].mean()) <= 1.0


@pytest.mark.parametrize("name", ["cornell", "suzanne", "bbc-owl"])
def test_k13_regen_front_matches_eager_stages(dev, name):
    """regen_front on the card (K13 writing each stage into its slice of
    state0 and adding its base into base_sum) against the concatenation and
    the sum of the eager stages."""
    scene, camera, params, px, py, pk = _k13_tile(name, dev, w=40, h=23)
    base_key = rng.base_key(2 ** 33 + 23)
    with torch.no_grad():
        base_sum, state0, _ = integ.regen_front(scene, camera, params, base_key, 7, 2, px, py,
                                                3, 1024, pk, pk.no_glossy)
        rows, total = [], torch.zeros((3, px.shape[0]), device=dev)
        for s in range(3):
            key = rng.fold_in(rng.fold_in(base_key, 7 + s), 2)
            st, base = integ._first_bounce_eager(scene, camera, params, key, px, py, 1024,
                                                 "kernel", pk, pk.no_glossy, True)
            rows.append(st)
            total = total + base
    assert torch.equal(state0.view(torch.int32), torch.cat(rows).view(torch.int32))
    assert torch.equal(base_sum.view(torch.int32), total.view(torch.int32))


def test_k13_launches_per_render_stage(dev):
    """A render launches, per camera stage, K13a and K13b once each, K2 once
    and K11 twice, and counts each stage in ``k13.stages``."""
    params = RenderParams(width=64, height=64, samples_per_pixel=8, seed=1)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, camera))
    per_stage = []
    stage = integ._first_bounce_state
    wrappers = (ck.camera_rays, ck.first_bounce, ik.intersect_packed, rng.uniform_kernel)

    def counted(*a, **kw):
        before = [f.launches for f in wrappers]
        out = stage(*a, **kw)
        per_stage.append(tuple(f.launches - b for f, b in zip(wrappers, before)))
        return out

    tracing.reset()
    tracing.enable()
    integ._first_bounce_state = counted
    try:
        render(scene, camera, params, device="cuda")
        counters = tracing.snapshot()["counters"]
    finally:
        integ._first_bounce_state = stage
        tracing.disable()
        tracing.reset()
    assert per_stage and set(per_stage) == {(1, 1, 1, 2)}, per_stage
    assert counters["k13.stages"] == len(per_stage)


def test_k13_not_in_a_train_step(dev):
    """A training step differentiates its materials: every camera stage is
    the eager one, K13 launches nothing and counts no stage."""
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    params = RenderParams(width=16, height=16, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=4, intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    px = torch.arange(256, dtype=torch.int32) % 16
    py = torch.arange(256, dtype=torch.int32) // 16
    step = make_sharded_train_step(scene, params, device="cuda")
    before = (ck.camera_rays.launches, ck.first_bounce.launches)
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("pt3.train.step"):
            step(TrainState(scene.materials, camera, 0), rng.base_key(2), px, py,
                 torch.full((256, 3), 0.25))
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    assert (ck.camera_rays.launches, ck.first_bounce.launches) == before
    assert "k13.stages" not in counters


def test_k13_cornell_render_matches_eager_render(dev, monkeypatch):
    """A cornell 64^2 render with K13 equals, bit for bit, the same render
    with every camera stage eager."""
    params = RenderParams(width=64, height=64, samples_per_pixel=8, seed=1)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, camera))
    before = ck.first_bounce.launches
    k13 = render(scene, camera, params, device="cuda")
    assert ck.first_bounce.launches > before
    monkeypatch.setattr(integ, "uses_camera_kernel", lambda *a: False)
    before = ck.first_bounce.launches
    eager = render(scene, camera, params, device="cuda")
    assert ck.first_bounce.launches == before
    assert np.array_equal(k13.sum, eager.sum) and np.array_equal(k13.count, eager.count)
