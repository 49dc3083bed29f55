"""Command-line interface of the PyTorch/CUDA port (reference:
src/main/main.cpp:370-473).

The same flags, defaults and output lines as the JAX package's CLI, plus
``--device {cuda,cpu}`` (default ``cuda``; a CUDA run without a card fails).
Every way (dod/wavefront, oo/megakernel, fp/functional) and ``--scene
smallpt`` run on either device; ``--dtype float64`` runs on the CPU only.
``--devices`` above 1 is not ported yet.
Tuning (rng mode, passes per launch, feedback sort, tail compaction) is the
runtime autotune's job on the card (models/render.autotune_decisions).
``-h`` means HEIGHT like the reference; use --help for help.

Usage:
    python -m pt_three_ways_tpu_torch.cli [options] output.png
"""

from __future__ import annotations

import argparse
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
                   help="number of devices (only 1 is ported)")
    p.add_argument("--dp", type=int, default=1, help="sample-parallel replicas")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render device (default cuda)")
    p.add_argument("output", help="output filename")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from .models.ways import WAYS

    if args.way not in WAYS:
        print(f"Unknown way {args.way}", file=sys.stderr)
        return 1
    if args.devices > 1:
        print("--devices > 1 is not yet ported", file=sys.stderr)
        return 1
    if args.dtype == "float64" and args.device != "cpu":
        print("--dtype float64 runs on the CPU only: add --device cpu", file=sys.stderr)
        return 1

    import torch

    from .models.catalog import EPSILON_HINT, create_scene, hint_key
    from .models.render import render, resolve_device
    from .models.scene import SceneBuilder, StatsSceneBuilder, auto_epsilon
    from .utils.framebuffer import ArrayOutput
    from .utils.png import write_png
    from .utils.render_params import RenderParams

    device = resolve_device(args.device)
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
    print(stats.report())

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
    output = render(
        scene,
        camera,
        params,
        way=args.way,
        update_fn=save,
        save_every_seconds=float(args.save_every),
        progress=args.progress,
        tri_chunk=args.tri_chunk,
        resume_from=args.resume,
        device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - start
    save(output)

    total_samples = output.total_samples()
    print(f"Took {elapsed:.3f}s")
    print(f"Total samples: {total_samples}")
    print(f"Samples/ms: {total_samples / (elapsed * 1000.0):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
