"""Render configuration.

Mirrors the reference's RenderParams POD (src/util/RenderParams.h:3-13) with
the same extra fields, names and defaults as the JAX package's
``RenderParams``, so one configuration drives both.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderParams:
    width: int = 1920
    height: int = 1080
    preview: bool = False
    samples_per_pixel: int = 40
    max_depth: int = 5
    first_bounce_u_samples: int = 4
    first_bounce_v_samples: int = 4
    seed: int = 0

    # --- extensions with no reference analogue ---
    # Compute dtype: "float32", or "float64" (the scan wavefront and the
    # other ways on the CPU; a CUDA render raises).
    dtype: str = "float32"
    # Geometric epsilon; scenes with large coordinates override it.
    epsilon: float = 1e-4
    # Passes fused into one device dispatch (spp is split into ceil(spp/k)
    # dispatches of k passes each). 0 = auto.
    passes_per_dispatch: int = 0
    # Feedback work-sort for the regenerating megakernel: chain each
    # dispatch's per-lane bounce counts into the next dispatch's lane order
    # so blocks become work-homogeneous (bit-exact permutation).
    regen_feedback_sort: bool = False
    # Number of devices (only 1 is ported).
    max_devices: int = 1
    # Kept for parity with the JAX configuration; unused.
    use_bvh: bool = True
    # Intersection backend: "auto" (the CUDA kernels on a CUDA device, the
    # broadcast "xla"-style scan elsewhere), "xla", or "kernel" (the kernel
    # wrappers: CUDA kernels for CUDA tensors, their plain versions on CPU).
    intersector: str = "auto"
    # Per-bounce recomputation in the backward: trace_pass runs each bounce
    # under torch.utils.checkpoint, so autograd keeps O(path state) a bounce
    # (the replay path ignores it: its backward recomputes nothing).
    remat: bool = False
    # Kill paths whose throughput is exactly zero (identical images, much
    # less work in light-dominated scenes).
    kill_dead_paths: bool = True
    # Regenerating megakernel: "auto" uses it whenever the kernel
    # intersector is active; "off" keeps the per-bounce scan wavefront.
    fused: str = "auto"
    # Bounce-uniform source for the regenerating megakernel: "auto"/"kernel"
    # hashes (lane, sample, depth, seed) inside the kernel; "table" feeds
    # precomputed threefry tables that are bit-compatible with the scan
    # wavefront. Images from the two modes agree statistically.
    rng_mode: str = "auto"
    # Tail compaction for the in-kernel-RNG megakernel: each block's bounce
    # loop stops once its live lanes drop below this fraction of the block;
    # survivors are packed densely and a continuation dispatch finishes
    # them (exact — it resumes the identical in-flight state). 0 disables.
    regen_tail_frac: float = 0.0
    # Runtime auto-tuning (models/render.autotune_decisions): on a CUDA
    # device with every regen knob at its default, the first pass group's
    # per-lane bounce counts choose (rng_mode, passes_per_dispatch,
    # feedback_sort, tail_frac).
    autotune: bool = True
    # Number of tail-compaction continuation levels.
    regen_tail_levels: int = 1

    @property
    def first_bounce_samples(self) -> int:
        return self.first_bounce_u_samples * self.first_bounce_v_samples

    def replace(self, **kw) -> "RenderParams":
        return replace(self, **kw)
