"""Offline merge tool (reference: src/main/raw_to_png.cpp).

Loads N ``.raw`` checkpoints (the port's, the JAX package's or the C++
reference's: the format is the same), accumulates them exactly
(``utils/framebuffer.merge``: sum, count addition on the arrays it has
loaded to report each file's samples per pixel), reports the average
samples per pixel, and writes a PNG. It runs on the host and touches no
device. ``utils/native.raw_merge_native`` writes the same bytes for a
caller that holds only the paths.

Usage: python -m pt_three_ways_tpu_torch.raw_to_png out.png in1.raw [in2.raw ...]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raw_to_png")
    p.add_argument("output", help="output PNG filename")
    p.add_argument("inputs", nargs="+", help="input .raw files")
    args = p.parse_args(argv)

    from .utils.framebuffer import ArrayOutput, merge
    from .utils.png import write_png

    loaded = []
    for name in args.inputs:
        a = ArrayOutput.load(name)
        spp = a.total_samples() / (a.width * a.height)
        print(f"{name}: {a.width}x{a.height}, {spp:.2f} spp")
        loaded.append(a)
    acc = merge(loaded)
    avg = acc.total_samples() / (acc.width * acc.height)
    print(f"Average spp: {avg:.2f}")
    write_png(args.output, acc.to_srgb8())
    return 0


if __name__ == "__main__":
    sys.exit(main())
