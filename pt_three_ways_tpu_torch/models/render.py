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
    from .integrator import resolve_rng_mode
    from ..ops.megakernel import S_COUNT_MAX, PackedSceneStream

    if torch.device(device).type != "cpu" and (params.dtype == "float64"
                                                or has_float64(scene, camera)):
        raise ValueError("float64 renders run on the CPU only (pass device='cpu')")
    dev = resolve_device(device)
    scene = scene.to(dev)
    camera = camera.to(dev)
    width, height = params.width, params.height
    start_sample = 0
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
    out = ArrayOutput(width, height)
    if resume_from is not None:
        out += prev

    regen = uses_regen(params, way, dev)
    on_cuda = dev.type == "cuda"
    # 8 passes per launch on the card (also the autotune probe's group
    # size); 1 on the CPU like the JAX package's CPU branch. An explicit
    # params.passes_per_dispatch pins the group size.
    ppd = params.passes_per_dispatch or (8 if on_cuda else 1)
    if regen and resolve_rng_mode(params) == "kernel":
        ppd = min(ppd, S_COUNT_MAX)
    autotune = (
        params.autotune
        and on_cuda
        and regen
        and params.rng_mode == "auto"
        and not params.regen_feedback_sort
        and params.regen_tail_frac == 0.0
        and params.samples_per_pixel > max(8, params.passes_per_dispatch)
    )
    probe_n = min(ppd, params.samples_per_pixel)
    pass_fns = {}
    cur_params = params
    packed = None
    if regen:
        # K4's and K5's culled searches (and K6) read the window boxes
        packed = PackedSceneStream(scene)

    def get_fn(n):
        if n not in pass_fns:
            pass_fns[n] = make_pass_fn(scene, camera, cur_params, way, tri_chunk,
                                       n, packed=packed)
        return pass_fns[n]

    # with autotune the final group size may grow to 64: size the tile rows
    # for the worst case so tiling never changes mid-render
    rows_per_tile = _tile_rows(params, 64 if autotune else ppd, regen=regen,
                               device=dev)
    n_tiles = math.ceil(height / rows_per_tile)
    xs = torch.arange(width, dtype=torch.int32, device=dev).repeat(rows_per_tile)
    base_ys = torch.arange(rows_per_tile, dtype=torch.int32,
                           device=dev).repeat_interleave(width)

    base_key = rng.base_key(params.seed)
    total = params.samples_per_pixel * n_tiles
    prog = Progressifier(total) if progress else None
    next_save = time.monotonic() + save_every_seconds

    spp = params.samples_per_pixel
    done = start_sample * n_tiles
    sample = start_sample
    feedback = regen and (params.regen_feedback_sort or autotune)
    if autotune:
        # the probe group must return lane counts: run it through the
        # feedback-fn shape with a zero (identity) sort key
        cur_params = params.replace(regen_feedback_sort=True)
    k_sub = max(params.first_bounce_samples, 1)
    tile_counts = {}

    def apply_tuning():
        nonlocal cur_params, ppd, feedback
        counts = np.concatenate(
            [tile_counts[t].cpu().numpy() for t in sorted(tile_counts)]
        )
        dec = autotune_decisions(
            counts, probe_n, max(params.max_depth - 1, 0),
            scene.num_triangles, scene.num_spheres,
        )
        cur_params = params.replace(
            rng_mode=dec["rng_mode"],
            regen_feedback_sort=dec["feedback_sort"],
            regen_tail_frac=dec["tail_frac"],
        )
        if not params.passes_per_dispatch:
            ppd = dec["passes_per_dispatch"]
            if resolve_rng_mode(cur_params) == "kernel":
                ppd = min(ppd, S_COUNT_MAX)
        pass_fns.clear()
        feedback = regen and dec["feedback_sort"]
        if not feedback:
            tile_counts.clear()

    def tile_px(tile):
        return xs, base_ys + tile * rows_per_tile

    if autotune and start_sample > 0:
        # resumed run: trace the original first group again (radiance
        # discarded) so the tuning decisions match the uninterrupted run
        probe_fn = get_fn(probe_n)
        for tile in range(n_tiles):
            px, py = tile_px(tile)
            zk = torch.zeros((px.shape[0] * k_sub,), dtype=torch.int32, device=dev)
            _, cnts = probe_fn(base_key, 0, tile, px, py, zk)
            tile_counts[tile] = cnts
        apply_tuning()
        autotune = False

    # one-launch-deep pipeline: tile t+1 is enqueued on the device before
    # tile t's result is copied back and accumulated on the host
    pending = None

    def drain():
        nonlocal pending, done
        if pending is None:
            return
        tile, n, radiance = pending
        pending = None
        y0 = tile * rows_per_tile
        rows = min(rows_per_tile, height - y0)
        rad = radiance.detach().cpu().numpy().astype(np.float64)
        out.sum[y0:y0 + rows] += rad.reshape(rows_per_tile, width, 3)[:rows]
        out.count[y0:y0 + rows] += n
        done += n
        if prog:
            prog.update(done)

    while sample < spp:
        n = min(ppd, spp - sample)
        fn = get_fn(n)
        for tile in range(n_tiles):
            px, py = tile_px(tile)
            if feedback:
                key_in = tile_counts.get(tile)
                if key_in is None:
                    key_in = torch.zeros((px.shape[0] * k_sub,), dtype=torch.int32,
                                         device=dev)
                radiance, new_counts = fn(base_key, sample, tile, px, py, key_in)
                # counts chain on the device, in unsorted lane order
                tile_counts[tile] = new_counts
            else:
                radiance = fn(base_key, sample, tile, px, py)
            drain()
            pending = (tile, n, radiance)
        sample += n
        if autotune:
            apply_tuning()
            autotune = False
        # checkpoint only at pass-group boundaries: every tile is at the same
        # sample count, so a later --resume continues bit-identically
        if update_fn and save_every_seconds > 0:
            now = time.monotonic()
            if now > next_save:
                drain()
                update_fn(out)
                next_save = now + save_every_seconds
    drain()
    return out
