"""Command-line interface of the PyTorch/CUDA port (reference:
src/main/main.cpp:370-473).

The same flags, defaults and output lines as the JAX package's CLI, plus
``--device {cuda,cpu}`` (default ``cuda``; a CUDA run without a card fails).
Every way (dod/wavefront, oo/megakernel, fp/functional) and ``--scene
smallpt`` run on either device; ``--dtype float64`` runs on the CPU only.
``--devices N --dp D`` renders over a (dp, sp) mesh of N ranks, one process
per device (parallel/shard.render_sharded): inside a torchrun world it
joins that world (its first N ranks make the mesh, ``--devices 1`` too),
otherwise it starts N local ranks itself
(parallel/distributed.spawn; NCCL between cards, gloo with ``--device
cpu``); rank 0 prints and writes. With ``--device cuda`` fewer than N cards
is an error. ``--scene smallpt`` runs on one device, as in the JAX package.
``--trace-out FILE.json`` builds the scene and renders under
``torch.profiler`` with the program's spans on (utils/tracing), and writes
the profiler's Chrome trace: spans and kernels on one timeline.
Tuning (rng mode, passes per launch, feedback sort, tail compaction) is the
runtime autotune's job on the card (models/render.autotune_decisions).
``-h`` means HEIGHT like the reference; use --help for help.

Usage:
    python -m pt_three_ways_tpu_torch.cli [options] output.png
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import sys
import time

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pt_three_ways_tpu_torch", add_help=False,
        description="PyTorch/CUDA path tracer (pt-three-ways capability set)",
    )
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("-w", "--width", type=int, default=1920, help="output image width")
    p.add_argument("-h", "--height", type=int, default=1080, help="output image height")
    p.add_argument("--max-cpus", type=int, default=1,
                   help="accepted for reference compatibility")
    p.add_argument("--spp", type=int, default=40, help="number of samples per pixel")
    p.add_argument("--first-bounce-u", type=int, default=4,
                   help="number of first bounce u samples")
    p.add_argument("--first-bounce-v", type=int, default=4,
                   help="number of first bounce v samples")
    p.add_argument("--max-depth", type=int, default=5, help="maximum recursion depth")
    p.add_argument("--seed", type=int, default=0,
                   help="set rendering seed (0 to use random seed)")
    p.add_argument("--preview", action="store_true", help="super quick preview")
    p.add_argument("--save-every", type=int, default=30,
                   help="periodically save (every secs), 0 to disable")
    p.add_argument("--way", default="dod",
                   help="which way: dod/wavefront (default), oo/megakernel, fp/functional")
    p.add_argument("--scene", default="cornell", help="which scene to render")
    p.add_argument("--raw", action="store_true", help="output in raw form")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                   help="compute dtype (float64 only with --device cpu)")
    p.add_argument("--epsilon", type=float, default=None,
                   help="geometric epsilon (default: derived from scene scale "
                        "— models/scene.auto_epsilon)")
    p.add_argument("--tri-chunk", type=int, default=1024,
                   help="triangles per intersection chunk (scan wavefront)")
    p.add_argument("--passes-per-dispatch", type=int, default=0,
                   help="sample passes fused per megakernel launch "
                        "(0 = runtime-autotuned on the card)")
    p.add_argument("--progress", action="store_true", help="print progress lines")
    p.add_argument("--resume", default=None, metavar="CKPT.raw",
                   help="resume from a .raw checkpoint of the same config")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the render over N devices, one process each "
                        "(1 = single device)")
    p.add_argument("--dp", type=int, default=1,
                   help="sample-parallel replicas within --devices")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render device (default cuda)")
    p.add_argument("--trace-out", default=None, metavar="FILE.json",
                   help="write a Chrome trace of the scene build and render "
                        "(torch.profiler, with the program's spans)")
    p.add_argument("output", help="output filename")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from .models.ways import WAYS

    if args.way not in WAYS:
        print(f"Unknown way {args.way}", file=sys.stderr)
        return 1
    if args.dtype == "float64" and args.device != "cpu":
        print("--dtype float64 runs on the CPU only: add --device cpu", file=sys.stderr)
        return 1
    if args.devices < 1 or args.dp < 1 or args.devices % args.dp:
        print(f"--dp {args.dp} does not divide --devices {args.devices}", file=sys.stderr)
        return 1
    if args.scene != "smallpt" and _in_torchrun():
        # the world's launcher placed the processes: its first --devices
        # ranks make the mesh, any others wait
        return _run(args, sharded=True)
    if args.devices > 1 and args.scene != "smallpt":
        import torch

        if args.device == "cuda":
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if cards < args.devices:
                print(f"--devices {args.devices} needs {args.devices} CUDA cards, one process "
                      f"each, but this machine has {cards}", file=sys.stderr)
                return 1
        from .parallel import distributed

        if args.seed == 0:  # every rank renders the same seed
            args.seed = random.SystemRandom().randrange(1, 2**31)
        return distributed.spawn(_run, args.devices, args, True, device=args.device)
    return _run(args)


@contextlib.contextmanager
def _traced(path, device, write: bool):
    """The block under ``torch.profiler`` (the card's activity too on a
    CUDA device) with the program's spans on; its Chrome trace written to
    ``path`` where ``write``. Without ``path``, the block alone."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from .utils import tracing

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        tracing.enable()
        try:
            yield
        finally:
            tracing.disable()
    if write:
        prof.export_chrome_trace(path)


def _in_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def _run(args, sharded: bool = False) -> int:
    """The render on this process: the whole of it, or this rank's part of
    the sharded one (rank 0 prints and writes)."""
    import torch

    from .models.catalog import EPSILON_HINT, create_scene, hint_key
    from .models.render import render, resolve_device
    from .models.scene import SceneBuilder, StatsSceneBuilder, auto_epsilon
    from .utils.framebuffer import ArrayOutput
    from .utils.png import write_png
    from .utils.render_params import RenderParams

    mesh = None
    if sharded:
        import torch.distributed as dist

        from .parallel import distributed
        from .parallel.mesh import make_mesh

        if not dist.is_initialized():
            distributed.initialize(device=args.device)
        mesh = make_mesh(n_devices=args.devices, dp=args.dp, device=args.device)
        if args.seed == 0:  # a torchrun world: rank 0 draws the seed for all
            pick = [random.SystemRandom().randrange(1, 2**31)]
            dist.broadcast_object_list(pick, src=0)
            args.seed = pick[0]
        if not mesh.member:
            return 0
        device = mesh.device
    else:
        device = resolve_device(args.device)
    quiet = mesh is not None and mesh.rank != 0
    seed = args.seed if args.seed != 0 else random.SystemRandom().randrange(1, 2**31)

    if args.scene == "smallpt":
        # the smallpt sidecar has its own camera and film (models/smallpt.py;
        # reference src/smallpt/smallpt.cpp)
        from .models.smallpt import render_smallpt
        from .utils.framebuffer import srgb8

        start = time.time()
        img = render_smallpt(args.width, args.height, args.spp, seed=seed, device=device)
        elapsed = time.time() - start
        if args.raw:
            ArrayOutput.from_mean(img, args.spp).save(args.output)
        else:
            write_png(args.output, srgb8(img))
        total = args.width * args.height * args.spp
        print(f"Took {elapsed:.3f}s")
        print(f"Total samples: {total}")
        print(f"Samples/ms: {total / (elapsed * 1000.0):.2f}")
        return 0
    params = RenderParams(
        width=args.width,
        height=args.height,
        preview=args.preview,
        samples_per_pixel=args.spp,
        max_depth=args.max_depth,
        first_bounce_u_samples=args.first_bounce_u,
        first_bounce_v_samples=args.first_bounce_v,
        seed=seed,
        dtype=args.dtype,
        epsilon=args.epsilon if args.epsilon is not None
        else EPSILON_HINT.get(hint_key(args.scene), 1e-4),
        passes_per_dispatch=args.passes_per_dispatch,
    )

    stats = StatsSceneBuilder()
    try:
        create_scene(stats, args.scene, params)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if not quiet:
        print(stats.report())

    with _traced(args.trace_out, device, not quiet):
        dtype = torch.float64 if args.dtype == "float64" else torch.float32
        builder = SceneBuilder()
        camera = create_scene(builder, args.scene, params, dtype)
        scene = builder.build(dtype)
        if args.epsilon is None and hint_key(args.scene) not in EPSILON_HINT:
            params = params.replace(epsilon=auto_epsilon(scene, camera))

        def save(output: ArrayOutput) -> None:
            if args.raw:
                output.save(args.output)
            else:
                write_png(args.output, output.to_srgb8())

        start = time.time()
        kw = dict(way=args.way, update_fn=save, save_every_seconds=float(args.save_every),
                  progress=args.progress, tri_chunk=args.tri_chunk, resume_from=args.resume,
                  device=device)
        if mesh is not None:
            from .parallel.shard import render_sharded

            output = render_sharded(scene, camera, params, mesh, **kw)
        else:
            output = render(scene, camera, params, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.time() - start
    if quiet:
        return 0
    save(output)

    total_samples = output.total_samples()
    print(f"Took {elapsed:.3f}s")
    print(f"Total samples: {total_samples}")
    print(f"Samples/ms: {total_samples / (elapsed * 1000.0):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
