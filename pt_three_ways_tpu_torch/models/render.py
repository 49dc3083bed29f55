"""Render orchestration: passes x tiles -> accumulation framebuffer.

Launches (tile, pass-group) programs back to back on the device and
accumulates finished groups on the host into a (sum, count) ArrayOutput —
the reference's associative accumulation contract
(src/oo/Renderer.cpp:93-141). Tiling exists for memory: a tile is sized so
the live path state (W*H*K paths, plus the regenerating megakernel's
per-sample tables) fits the device; small frames are a single tile.

On a CUDA device the main path is the regenerating megakernel
(``make_pass_fn`` -> integrator.trace_passes_fused), with the first pass
group doubling as the autotune probe (``autotune_decisions``); the scene is
packed with its window boxes (ops/megakernel.PackedSceneStream), which cull
K4's and K5's searches on the card, and a scene above the resident range takes K4's
stream mode (integrator.uses_stream). On the CPU
the default is the scan wavefront (integrator.trace_pass), one pass per
group, tiled exactly like the JAX package's CPU branch so the same keys
fold in. The other ways (models/ways.WAYS: ``oo``, ``fp`` and their
aliases) run one pass per group on either device, their intersections on
K2 where the kernel backend is active. ``params.dtype="float64"`` renders
on the CPU only.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import rng
from ..utils import tracing
from ..utils.framebuffer import ArrayOutput
from ..utils.progress import Progressifier
from ..utils.render_params import RenderParams

# CPU budgets: the JAX package's CPU values, so CPU renders tile (and fold
# tile indices into their keys) identically.
MAX_PATHS_PER_DISPATCH = 1 << 21
STATE_TABLE_BUDGET_BYTES = 4 << 30

# Tile size of the regen-waste estimate in autotune_decisions (kept equal
# to the JAX package's so both make the same decisions from the same
# counts).
AUTOTUNE_TILE = 1024


def cuda_budgets(device) -> tuple[int, int]:
    """(max live paths per launch, state-table bytes) on a CUDA device,
    from its memory. Per path the camera stage holds ~1 KB of float32 and
    int64 temporaries at its peak, so 1/8192 of memory per path keeps one
    launch's camera stage under an eighth of the card (2^23 paths on an
    80 GB card); the megakernel's per-sample tables get a fifth of memory
    (16 GB on an 80 GB card)."""
    total = torch.cuda.get_device_properties(device).total_memory
    paths = 1 << max(21, min(24, int(math.log2(max(total // 8192, 1)))))
    return paths, int(total // 5)


def _budgets(device) -> tuple[int, int]:
    if torch.device(device).type == "cuda":
        return cuda_budgets(device)
    return MAX_PATHS_PER_DISPATCH, STATE_TABLE_BUDGET_BYTES


def uses_regen(params: RenderParams, way: str, device) -> bool:
    """True when render() launches the regenerating megakernel (float32
    only: a float64 render takes the scan wavefront)."""
    from .integrator import resolve_intersector

    backend = resolve_intersector(params, device)
    return (
        way in ("dod", "wavefront")
        and params.dtype == "float32"
        and not params.preview
        and backend == "kernel"
        and params.fused != "off"
        and params.kill_dead_paths
    )


def _tile_rows(params: RenderParams, ppd: int = 1, regen: bool = True,
               device="cpu") -> int:
    k = max(params.first_bounce_samples, 1)
    cap, budget = _budgets(device)
    if regen and ppd > 1:
        from .integrator import resolve_rng_mode

        nb = max(params.max_depth - 1, 0)
        if resolve_rng_mode(params) == "kernel":
            # the [10*SP, N] sample state table, SP = samples padded to 8
            sp_pad = -(-ppd // 8) * 8
            bytes_per_path = 10 * 4 * sp_pad
        else:
            bytes_per_path = (11 + 4 * nb) * 4 * ppd
        cap = min(cap, max(budget // bytes_per_path, 1 << 16))
    max_pixels = max(cap // k, params.width)
    return max(1, min(params.height, max_pixels // params.width))


def autotune_decisions(counts: np.ndarray, s0: int, nb: int,
                       n_tri: int, n_sph: int) -> dict:
    """Regen tuning from the FIRST group's per-lane live-bounce counts:

      * mean realized depth / max depth -> "closed" (cornell-like, paths
        never escape) vs open/emissive;
      * regen waste estimate (1 - sum / (n_tiles * tile max)) -> whether
        the feedback work-sort + tail compaction pay.

    Returns dict(rng_mode, passes_per_dispatch, feedback_sort, tail_frac),
    the same decisions as the JAX package for the same counts.
    """
    counts = np.asarray(counts, np.int64)
    n = counts.size
    total = int(counts.sum())
    m = total / max(n * s0 * max(nb, 1), 1)
    pad = (-n) % AUTOTUNE_TILE
    tiles = np.pad(counts, (0, pad)).reshape(-1, AUTOTUNE_TILE)
    disp = int((tiles.max(axis=1) * AUTOTUNE_TILE).sum())
    waste = 1.0 - total / max(disp, 1)
    live_frac = float((counts > 0).mean())
    closed = m > 0.7
    small = n_tri <= 64 and n_sph <= 64
    if closed and small:
        return dict(rng_mode="table", passes_per_dispatch=8,
                    feedback_sort=False, tail_frac=0.0)
    divergent = waste > 0.25 and live_frac > 0.05
    return dict(
        rng_mode="kernel",
        passes_per_dispatch=64,
        feedback_sort=divergent,
        tail_frac=0.125 if divergent else 0.0,
    )


def make_pass_fn(scene, camera, params: RenderParams, way: str = "dod",
                 tri_chunk: int = 1024, n_passes: int = 1,
                 packed=None) -> Callable:
    """fn(base_key, sample0, tile_idx, px, py[, sort_key]) -> radiance SUM
    [R, 3] over ``n_passes`` consecutive sample passes (plus the per-lane
    counts when the feedback sort is on). Keys fold exactly like the
    unfused path: fold_in(fold_in(base, sample), tile)."""
    from .integrator import trace_passes_fused
    from .ways import WAYS

    trace = WAYS[way]
    if uses_regen(params, way, scene.device):
        if params.regen_feedback_sort:
            def pass_fn(base_key, sample0, tile_idx, px, py, sort_key):
                rad, cnts = trace_passes_fused(
                    scene, camera, params, base_key, sample0, tile_idx,
                    px, py, n_passes, tri_chunk,
                    sort_key=sort_key, with_lane_counts=True, packed=packed,
                )
                # running-sum key: a lane's expected depth is a stationary
                # property of its pixel's geometry
                return rad, sort_key + cnts

            return pass_fn

        def pass_fn(base_key, sample0, tile_idx, px, py):
            return trace_passes_fused(
                scene, camera, params, base_key, sample0, tile_idx,
                px, py, n_passes, tri_chunk, packed=packed,
            )

        return pass_fn

    def pass_fn(base_key, sample0, tile_idx, px, py):
        acc = torch.zeros((px.shape[0], 3), dtype=camera.centre.dtype, device=px.device)
        for i in range(n_passes):
            key = rng.fold_in(rng.fold_in(base_key, sample0 + i), tile_idx)
            acc = acc + trace(scene, camera, params, key, px, py, tri_chunk)
        return acc

    return pass_fn


def has_float64(*trees) -> bool:
    """Whether any tensor in ``trees`` (tensors and nested tuples of them,
    such as a Scene or a Camera) is float64."""
    return any(t.dtype == torch.float64 if isinstance(t, torch.Tensor)
               else isinstance(t, tuple) and has_float64(*t) for t in trees)


def resolve_device(device) -> torch.device:
    """The render device; a CUDA request without a card raises (no silent
    CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to render on the CPU)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return dev


def render(
    scene,
    camera,
    params: RenderParams,
    way: str = "dod",
    update_fn: Optional[Callable[[ArrayOutput], None]] = None,
    save_every_seconds: float = 0.0,
    progress: bool = False,
    tri_chunk: int = 1024,
    resume_from: Optional[str] = None,
    device="cuda",
) -> ArrayOutput:
    """Full render: samples_per_pixel passes over all pixels on ``device``,
    by ``way`` (a key of models/ways.WAYS).

    ``update_fn`` receives the partially-accumulated ArrayOutput at most once
    per ``save_every_seconds`` (main.cpp:331-343), at pass-group boundaries.

    ``resume_from``: a ``.raw`` checkpoint of a previous run of the SAME
    configuration; rendering continues at the next sample pass. The
    counter-based RNG makes the result bit-identical to an uninterrupted
    run when the checkpoint falls on one of its pass-group boundaries (where
    ``--save-every`` writes). On resume the autotune probe group is traced
    again (radiance discarded) so the same decisions are reached.
    """
    return render_rounds(scene, camera, params, None, way, tri_chunk, update_fn,
                         save_every_seconds, progress, resume_from, device)


@tracing.spanned("pt3.render")
def render_rounds(scene, camera, params: RenderParams, mesh, way: str, tri_chunk: int,
                  update_fn, save_every_seconds: float, progress: bool,
                  resume_from: Optional[str], device) -> ArrayOutput:
    """The tile and round loop of render() (``mesh=None``) and of
    parallel/shard.render_sharded (this rank's ``parallel/mesh.Mesh``):
    resume, the runtime autotune, memory tiling, the feedback sort's key
    chain and throttled checkpoints (on the mesh's first rank).

    A round takes a block of up to S samples on each of the dp replicas
    (the last round masks the inactive ones, so the output holds exactly
    spp samples); each rank traces its sp shard of every tile (the tile's
    rays padded to a multiple of sp, the padding clamped to the last row)
    and gathers the shards over sp. The pass fns are
    ``make_pass_fn`` without a mesh and ``parallel/shard
    .make_sharded_pass_fn`` on one: they differ in a single-pass launch,
    which the mesh traces by the way's pass, as the JAX package's sharded
    render does. Without a mesh the autotune runs on the card only, as the
    JAX package's render() runs it on the TPU only; on a mesh it also runs
    on the CPU with the kernel intersector (the kernels' plain versions),
    as the JAX package's sharded render does in interpret mode. The CPU
    tests hold each against its JAX counterpart.

    Traced (``utils/tracing``) as ``pt3.render``, the frame's root, with
    ``pt3.render.pack`` (the scene's pack and the tiling), one
    ``pt3.render.launch`` a (round, tile) launch, ``pt3.render.autotune``
    and ``pt3.render.drain``; ``pt3.sync.scene`` (the scene's copy),
    ``pt3.sync.autotune`` and ``pt3.sync.drain`` are its waits on the
    card."""
    from .integrator import resolve_rng_mode
    from ..ops.megakernel import S_COUNT_MAX, PackedSceneStream

    if torch.device(device).type != "cpu" and (params.dtype == "float64"
                                                or has_float64(scene, camera)):
        raise ValueError("float64 renders run on the CPU only (pass device='cpu')")
    dev = resolve_device(device)
    with tracing.span("pt3.sync.scene"):  # copies from host memory wait for the card
        scene = scene.to(dev)
        camera = camera.to(dev)
    width, height = params.width, params.height
    spp = params.samples_per_pixel
    start_sample = 0
    out = ArrayOutput(width, height)
    if resume_from is not None:
        prev = ArrayOutput.load(resume_from)
        if (prev.width, prev.height) != (width, height):
            raise ValueError(
                "resume checkpoint size mismatch: "
                f"{prev.width}x{prev.height} vs {width}x{height}"
            )
        if prev.count.max() != prev.count.min():
            raise ValueError(
                "resume checkpoint has non-uniform sample counts "
                f"({prev.count.min()}..{prev.count.max()}); checkpoints are "
                "written at pass boundaries so this is not a pt3 checkpoint"
            )
        start_sample = int(prev.count.min())
        out += prev

    if mesh is None:
        dp, sp, sp_idx = 1, 1, 0

        def gather(t):
            return t
    else:
        from ..parallel.mesh import all_gather

        dp, sp, sp_idx = mesh.shape["dp"], mesh.shape["sp"], mesh.sp_idx

        def gather(t):
            return all_gather(t, mesh.sp_group)
    leader = sp_idx == 0 and (mesh is None or mesh.dp_idx == 0)
    regen = uses_regen(params, way, dev)
    on_cuda = dev.type == "cuda"

    def cap(p, s):
        """A block size capped by the samples a replica has and, for the
        in-kernel RNG, by its per-lane liveness mask."""
        s = min(s, max(spp // dp, 1))
        if regen and resolve_rng_mode(p) == "kernel":
            s = min(s, S_COUNT_MAX)
        return s

    # 8 passes per launch on the card (also the autotune probe's group
    # size); 1 on the CPU like the JAX package's CPU branch. An explicit
    # params.passes_per_dispatch pins the group size.
    S = cap(params, params.passes_per_dispatch or (8 if on_cuda else 1))
    # The runtime autotune: the first round doubles as the probe; its
    # per-lane bounce counts (summed over dp) drive autotune_decisions, and
    # the remaining rounds run the derived (rng_mode, S, sort, tail).
    autotune = (
        params.autotune
        and regen
        and (on_cuda or (mesh is not None and params.intersector == "kernel"))
        and params.rng_mode == "auto"
        and not params.regen_feedback_sort
        and params.regen_tail_frac == 0.0
        and spp > max(8, params.passes_per_dispatch)
        and spp // dp > 1
    )
    feedback = regen and (params.regen_feedback_sort or autotune)
    cur_params = params
    if autotune:
        if not params.passes_per_dispatch:
            # the probe needs a multi-pass block for its lane counts
            S = cap(params, max(S, 8))
        # the probe returns lane counts: the feedback fn with a zero
        # (identity) sort key
        cur_params = params.replace(regen_feedback_sort=True)
    probe_n = S
    pass_fns = {}

    def get_fn(n):
        if n not in pass_fns:
            if mesh is None:
                pass_fns[n] = make_pass_fn(scene, camera, cur_params, way, tri_chunk, n,
                                           packed=packed)
            else:
                from ..parallel.shard import make_sharded_pass_fn

                pass_fns[n] = make_sharded_pass_fn(
                    scene, camera, cur_params, mesh, way, tri_chunk, n, regen=regen,
                    feedback_sort=feedback, packed=packed)
        return pass_fns[n]

    with tracing.span("pt3.render.pack"):
        # K4's and K5's culled searches (and K6) read the window boxes
        packed = PackedSceneStream(scene) if regen else None
        # with autotune the final group size may grow to 64: size the tile
        # rows for the worst case so tiling never changes mid-render (on a
        # mesh as if unsharded: each device holds 1/sp of a tile)
        rows_per_tile = _tile_rows(params, 64 if autotune else S, regen=regen, device=dev)
        n_tiles = math.ceil(height / rows_per_tile)
        shard = -(-rows_per_tile * width // sp)
        flat = torch.arange(sp_idx * shard, (sp_idx + 1) * shard, dtype=torch.int32,
                            device=dev)
        xs = flat % width
        base_ys = torch.clamp(flat // width, max=rows_per_tile - 1)

    base_key = rng.base_key(params.seed)
    prog = Progressifier(spp * n_tiles) if progress and leader else None
    next_save = time.monotonic() + save_every_seconds
    done = start_sample * n_tiles
    sample = start_sample
    k_sub = max(params.first_bounce_samples, 1)
    # the feedback sort's per-lane keys, this rank's shard of each tile's,
    # chained on the device in unsorted lane order
    tile_keys = {}

    def tile_py(tile):
        return torch.clamp(base_ys + tile * rows_per_tile, max=height - 1)

    def zero_key():
        return torch.zeros((shard * k_sub,), dtype=torch.int32, device=dev)

    def apply_tuning():
        """Decides from the probe's counts of every tile, gathered over sp
        in the global lane order (the decision bins lanes in tiles of
        AUTOTUNE_TILE, so every rank must see the same order), and rebuilds
        the pass fns."""
        nonlocal cur_params, S, feedback
        with tracing.span("pt3.render.autotune"):
            with tracing.span("pt3.sync.autotune"):
                counts = [gather(tile_keys[t]).cpu() for t in sorted(tile_keys)]
            dec = autotune_decisions(
                np.concatenate([c.numpy() for c in counts]), probe_n * dp,
                max(params.max_depth - 1, 0), scene.num_triangles, scene.num_spheres,
            )
            cur_params = params.replace(
                rng_mode=dec["rng_mode"],
                regen_feedback_sort=dec["feedback_sort"],
                regen_tail_frac=dec["tail_frac"],
            )
            if not params.passes_per_dispatch:
                S = cap(cur_params, dec["passes_per_dispatch"])
            pass_fns.clear()
            feedback = regen and dec["feedback_sort"]
            if not feedback:
                tile_keys.clear()

    if autotune and start_sample > 0:
        # resumed run: trace the original probe round again (radiance
        # discarded) so the decisions match the uninterrupted run's
        probe_fn = get_fn(probe_n)
        for tile in range(n_tiles):
            with tracing.span("pt3.render.launch"):
                _, tile_keys[tile] = probe_fn(base_key, 0, tile, xs, tile_py(tile), zero_key())
        apply_tuning()
        autotune = False

    # one-launch-deep pipeline: tile t+1 is enqueued on the device before
    # tile t's result is copied back and accumulated on the host
    pending = None

    def drain():
        nonlocal pending, done
        if pending is None:
            return
        tile, n_active, radiance = pending
        pending = None
        with tracing.span("pt3.render.drain"):
            y0 = tile * rows_per_tile
            rows = min(rows_per_tile, height - y0)
            with tracing.span("pt3.sync.drain"):
                rad = radiance.detach().cpu()
            rad = rad.numpy().astype(np.float64)[: rows_per_tile * width]
            out.sum[y0:y0 + rows] += rad.reshape(rows_per_tile, width, 3)[:rows]
            out.count[y0:y0 + rows] += n_active
        done += n_active
        if prog:
            prog.update(done)

    while sample < spp:
        remaining = spp - sample
        if remaining >= dp:
            # full blocks only: every replica renders exactly n samples
            n = min(S, remaining // dp)
            n_active = dp * n
        else:
            # trailing remainder: masked single-pass launches
            n = 1
            n_active = remaining
        fn = get_fn(n)
        for tile in range(n_tiles):
            py = tile_py(tile)
            with tracing.span("pt3.render.launch"):
                if feedback:
                    key_in = tile_keys.get(tile)
                    radiance, tile_keys[tile] = fn(base_key, sample, tile, xs, py,
                                                   zero_key() if key_in is None else key_in)
                else:
                    radiance = fn(base_key, sample, tile, xs, py)
            radiance = gather(radiance)
            drain()
            pending = (tile, n_active, radiance)
        sample += n_active
        if autotune:
            apply_tuning()
            autotune = False
        # checkpoint only at pass-group boundaries: every tile is at the same
        # sample count, so a later --resume continues bit-identically
        if update_fn and save_every_seconds > 0 and leader:
            now = time.monotonic()
            if now > next_save:
                drain()
                update_fn(out)
                next_save = now + save_every_seconds
    drain()
    return out
