#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pt_three_ways_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It exits non-zero,
printing no result, when there is no CUDA device or the package is missing.

Phases (one line each, any failure stops the run):
  1. card, versions, and the build of every CUDA kernel from csrc/ (nvcc,
     sm_90a, one process per source, all started together, with the older
     K2, K4, K5, K7, K8, K9 and K10 of PREV_COMMIT and this tree's sources
     again with a flag (ALT_BUILDS: the culled build of megakernel.cu, where
     a one-chunk scene takes the culled warp search; K2 with the per-lane
     scan from 8, 12, 16 voters or never; K8 with its registers capped for 3
     and 4 blocks an SM; K10 with the culled warp search on one-chunk
     scenes)), with each kernel instance's registers and spills (and the
     older K10's, the other builds');
  2. K11 (ops/rng.uniforms) bit for bit against the plain int64 threefry,
     float32 and float64, on a cornell camera stage's and a training pass's
     draws, timed alone and through uniforms beside the plain version, its
     issue floor (SASS_THREEFRY) and its bytes; each kernel's wrapper
     against the same wrapper with its plain PyTorch version in place of the
     launch, at 256^2 camera tiles: K2 (cornell,
     suzanne; bit for bit), K5 (cornell), K4 (cornell, suzanne, and suzanne with tail
     compaction against the same run to exhaustion; with the cone angles
     zeroed, bit for bit against its plain version and its stream mode);
  3. a small-image reference: cornell 32^2 on the card in table-RNG mode
     (K2 + K5) against the CPU scan wavefront, pixel for pixel;
  4. the main path through render(): cornell at the CLI defaults (1920x1080,
     K=16, depth 5, 40 spp), cornell framed square (512^2, 16 spp) and
     suzanne (512^2, 16 spp); each starts with the autotune probe on K4 and
     goes on with K4 (feedback sort, tail compaction) or K5 as the probe
     decides; each writes a .raw (build/chip_smoke/) and a PNG
     (chiprun_out/); every launch counter is set to 0 just before each
     render and read just after it, and K11's equals the render's card
     calls of rng.uniforms, with no card draw by the plain threefry,
     K12's is 0 (a render's table does not require grad) and K13's is 2 a
     camera stage (K13a and K13b: every stage of a render is K13);
  5. each render again, every K2 launch held bit for bit (t, idx) against
     its plain version and the older K2, the first one's kernel timed in
     turns with the older K2 and, on a mesh, with K2's builds whose
     per-lane scan starts from other numbers of voters (and through the
     wrapper), with its bound and the test iterations a warp of either
     design runs; on the inputs each
     render gave them (the first call of its main pass
     group, after the probe): every kernel's wrapper against its plain
     version, timed, with the bound computed from those inputs; K4 also
     bit for bit against the older K4 and, on cornell, the culled build
     (every launch of the call) and timed in turns with them, with its lane
     utilisation and the share of shading
     events on glossy materials; K5 bit for bit against its plain version
     and the older K5, timed in turns with it, with the lane utilisation
     one lane a thread, its issue floor beside its bound and its
     registers; and the card's camera stage against the
     CPU's (whose rounding follows the JAX package's compiled CPU code) on
     every tile of the CLI-default render's first pass; K13 (the camera
     stage as K13a + K13b) on each of those tiles bit for bit against the
     eager stage on the card, its two kernels timed alone beside their
     bytes' bound, the whole stage through K13 and eager (its plain
     version);
  6. the training path through make_sharded_train_step: three replay steps
     on suzanne 512^2 (K=16, depth 5: the camera stage with K2, K7 with its
     residuals forward, four K8 launches backward), each split into forward
     and backward with its peak memory, the launch counters set to 0 just
     before the three steps and read just after (K11's against the steps'
     card calls of rng.uniforms, as in phase 4); one per-bounce wavefront
     step (fused="off") at the same size with camera gradients through K2's
     VJP; K7 (with and
     without residuals) and K8 (each bounce, and twice for bitwise
     repeatability) against their plain versions on the first step's
     inputs, timed, K7 also bit for bit against the older K7 and timed in
     turns with it, K8's cot_in bit for bit against the older K8's and its
     other register caps', timed in turns with them (its kernels a call
     from torch.profiler); no K13 launch (the steps differentiate their
     materials: every camera stage is eager); K12 (the camera stage's material gather VJP: one
     launch a pass, as many as the steps' gathers that differentiate the
     table) on the first step's call against its plain version and the
     float64 sums, bitwise repeatable, timed through its wrapper and alone
     (torch.profiler) beside its bound, the plain version and PyTorch's
     accumulating index_put_ (library_ms); K2 on the first step's launch as
     in phase 5; the
     geometry pack's rebuild against its material refresh; and the card's
     step against the CPU's on a 32^2 crop of cornell 512^2;
  7. the regenerating training path: three make_sharded_train_step steps
     with passes_per_step=8 on suzanne 512^2 (K=16, depth 5: eight camera
     stages with K2, one K4 launch in replay mode forward, one K9 launch
     backward, then the camera stages' autograd), each split into forward
     and backward with its K2/K4/K9 time and peak memory, the launch
     counters set to 0 just before the three steps and read just after (no
     K13 launch);
     the chain's K4 launch in replay mode (culled by the window boxes, no
     compaction) against its plain version, against K4 without replay (acc
     and counts bit-equal) and against the older K4's replay (bit for bit,
     timed in turns; see PREV_COMMIT), and K9 against its plain
     version and twice for bitwise repeatability, on the first step's
     inputs, timed in turns with the older K9 (every output bit-equal), both
     walks' lane utilisation and sectors per request from the counts, and
     two probes on both K9s (the lanes and their slots sorted by count; one
     material);
     K2 on the first step's eight launches as in phase 5;
     trace_passes_replay forward + backward with the feedback sort key chained across calls,
     in ms per pass; the card's regen step against the CPU's on a 32^2
     crop of cornell 512^2; and ten steps of the train_demo (cornell 256^2,
     Adam, 16 passes per step);
  8. the stream tier and the compacting wavefront: the crossover, the Woop
     table size and route of cornell (framed 16:9 and square) and
     suzanne(-sub1..3), and K4 resident against K4 stream (K6) and the older
     K4's resident scan on each at 256 wide (K=16, depth 5, S=8), on cornell
     also against the culled warp search (the culled build), bit for bit,
     timed in turns, and the gate the table implies; on suzanne-sub2 the
     same with tail compaction; suzanne-sub3 through render() at 512^2, 16
     spp twice, on the gate's route (resident) and with the gate lowered
     (stream: K6), the counters set to 0 just before each render and read
     just after (K4 in the one mode only; K6's launches are the stream
     render's), the two images bit-equal; the resident render again with
     K2 checked on every launch as in phase 5; each of the stream render's
     launches against the resident mode bit for bit, and its main launch
     against its plain version (K6's occupancy counted from it), against
     the older K4's stream mode (bit for bit, timed in turns), timed, with
     its bound, and the window x fan sweep;
     trace_passes_compact on cornell 256^2 (S=1: K10's one-chunk scan) and
     on suzanne 512^2 (S=4: its culled warp search), the counters set to 0
     just before each run and read just after; K10 against its plain
     version on each bounce of the first pass (with and without the winner
     record; bit for bit, on cornell's glossy materials cnt, t and idx bit
     for bit and every lane's state within rtol 1e-4 / atol 1e-5), against
     the older K10 and, on cornell, its culled build (bit for bit), timed in
     turns with them,
     with its live lanes, wholly dead warps, bound and registers; each run
     against trace_passes_fused in table mode (K5) on the same keys, with
     the ms per pass of compaction, K5 and K4 on suzanne; that K5 launch
     (the culled warp search) bit for bit against its plain version, the
     older K5 and one lane a thread, timed in turns with them, with its
     bound;
  9. the other ways, smallpt, remat and the merge: cornell at the CLI
     default (1920x1080, K=16, depth 5) with 1 spp through render() three
     ways, fused="off" dod, oo and fp, each within 2e-5 of dod per pixel,
     with its wall, peak memory and K2's launches and summed ms, K2 bit for
     bit against its plain version and the older K2 on the first launch of
     each way's first tile-pass and on a bounce launch with dead lanes (oo's
     and fp's first launches timed as in phase 5); smallpt at 1920x1080, 4
     spp, 40 bounces (finite, in [0, 1]), its _intersect on 2048 rays
     against a float64 oracle on the card, and a 64x48 render on the card
     against the CPU's; the fused="off" train step on suzanne 512^2 (K=16,
     depth 5) as dod, dod with remat and oo, and dod and oo with each
     material row's gradient summed over the lanes in float64, with its time
     and peak memory: remat within 1e-5 of dod's gradient norm, oo within
     1e-5 of dod with the sums in float64, and in float32 within 1e-5 plus
     the two ways' own rounding (each way's float32 sums against its float64
     sums); two CLI runs of --way oo (256^2, 2 spp, seeds 1 and 2)
     merged by raw_to_png, its PNG equal to to_srgb8() of the merge;
 10. the native host library and the (dp, sp) mesh: (a) the library
     (csrc/pt3native.cpp, g++) must build and load; the host scene build
     of cornell, suzanne, ce, bbc-owl, example1 and suzanne-sub3 with and
     without it (PT3_NO_NATIVE=1), bit-equal, timed on the host's clock;
     the Python and the native merge of two 1920x1080 .raw files, bytes
     equal, timed; (b) a 1-rank NCCL world: render_sharded of cornell
     (square) and suzanne 512^2 at 16 spp bit-equal to render(), the walls
     beside each other, the counters set to 0 just before each sharded
     render and read just after, the render again with every K2 launch
     held bit for bit against its plain version (suzanne's first timed)
     and, on cornell, K5's main call and K4's call (the probe) against
     their plain versions as in phase 5 (the "sharded" entries of their
     rows' by_path), and the 1-rank regen train step (S=8, suzanne 512^2,
     deterministic algorithms) bit-equal to mesh=None (the 1x1 mesh without
     groups); (c) two ranks sharing the card over
     gloo (its collectives staged through host memory), spawned by
     parallel/distributed.spawn: cornell and suzanne 256^2 at 16 spp on a
     dp=2 mesh (autotune off, 8 passes a launch) within rtol 1e-6 of
     render(), on an sp=2 mesh (the default flow) bit-equal twice and its
     4x4 block means within rtol 2e-2 / atol 2e-3 of render()'s, and a
     dp=2 regen train step (S=4 a rank) against the one-device step at
     S=8 (the same samples): loss within rtol 1e-5, updates within
     tests/test_torch_train.py's gates, with each wall and each rank's
     peak memory; (d) the CLI: --devices 2 on one card exits 1 naming the
     card count; --devices 1 in a 1-rank NCCL world (torchrun's variables
     set) takes the CLI's sharded branch (render_sharded on a mesh, rank 0
     writing), launches K2 and K4/K5 and writes the plain run's .raw.
The last two lines are the kernels JSON and the device JSON.

``--crossover NAMES`` builds, then prints only phase 8's crossover table for
the named scenes (e.g. suzanne-sub4,suzanne-sub5,suzanne-sub6: the measured
range behind ``ops/megakernel.RESIDENT_MAX_TRIANGLES``) and the device line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# The commit whose kernels the kernels line's prev_ms (K2: prev_kernel_ms,
# the kernel alone, beside this K2's kernel_ms; its ms is through the
# wrapper) times on the same inputs, in turns, and holds bit for bit
# against this tree's: K10 (one lane a thread, every triangle scanned from
# global memory, dead lanes on the general path), which this tree
# redesigned, and K2, K4, K5, K7, K8 and K9, which it did not. Its csrc
# comes from --prev, from build/prev_csrc, or from `git archive` when the
# checkout has that commit; without it prev_ms is null.
PREV_COMMIT = "75208f8"
PREV_CSRC = os.path.join(ROOT, "build", "prev_csrc")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP32
# (non-tensor) rate. Bounds are stated against these, beside the card's
# power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# FP32 operations per primitive test and per shading event, counted from
# csrc/pt3_device.cuh (a divide or a square root counts as one operation)
OPS_SPHERE = 23
OPS_TRIANGLE = 49
OPS_SLAB = 24
OPS_SHADE = 200
# the card's instruction issue rate (132 SMs x 4 schedulers x 32 lanes x
# 1.98 GHz): under -fmad=false every product and sum is one instruction, so
# a kernel's SASS instructions over this rate are a floor beside the bound;
# SASS instructions of one triangle test in the one-chunk scan's loop
ISSUE_PER_S = 33.5e12
SASS_TRIANGLE = 74
# SASS instructions a threefry uniform (csrc/threefry.cu, float32): a
# thread's path to its float4 store is 315 instructions for 4 elements
# (cuobjdump on sm_90a): 20 rounds of add, funnel shift and xor, 5 key
# injections, the float's assembly, the index and store arithmetic
SASS_THREEFRY = 315 / 4
# the replay residual slot K4 writes and K9 reads per live bounce: org3
# dir3 beta3, t, idx, sample, depth (float32)
REPLAY_SLOT_BYTES = 13 * 4
# passes per step of the regenerating training path (phase 7)
S_REGEN = 8
# phase 8's crossover scenes (name@16:9: framed 16:9, as the CLI default)
CROSSOVER_SCENES = ("cornell@16:9", "cornell", "suzanne", "suzanne-sub1", "suzanne-sub2",
                    "suzanne-sub3")
# per lane of the shading adjoint (csrc/replay.cuh bounce_bwd_lane): a hit
# lane recomputes its bounce (~110) and walks it back (~390, the diffuse
# branch); a live miss adds beta * environment
OPS_BWD_HIT = 500
OPS_BWD_MISS = 6
# bytes the shading adjoint must move per lane: a dead lane only row 9 and
# its cotangents (4 + 52 in, 52 out); a live miss adds t and beta; a hit
# lane its whole input (state 13, t, idx, uniforms 4, cot_out 13 floats)
BWD_BYTES_DEAD = 4 + 52 + 52
BWD_BYTES_MISS = BWD_BYTES_DEAD + 4 + 12
BWD_BYTES_HIT = 4 * (13 + 1 + 1 + 4 + 13) + 52


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "nvidia-smi unavailable"


def prev_csrc(arg):
    """The older kernels' csrc directory (see PREV_COMMIT), or None."""
    import io
    import tarfile

    if arg or os.path.isfile(os.path.join(PREV_CSRC, "megakernel.cu")):
        d = arg or PREV_CSRC
        return d if os.path.isfile(os.path.join(d, "megakernel.cu")) else None
    try:
        r = subprocess.run(["git", "-C", ROOT, "archive", PREV_COMMIT,
                            "pt_three_ways_tpu_torch/csrc"], capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    with tarfile.open(fileobj=io.BytesIO(r.stdout)) as tar:
        for m in tar.getmembers():
            if m.isfile():
                m.name = os.path.basename(m.name)
                tar.extract(m, PREV_CSRC, filter="data")
    return PREV_CSRC


def start_builds(jobs, nvcc, flags):
    """nvcc each (csrc directory, source name, library path, extra flags)
    into its own shared library, in the background (all started together);
    returns [(process, library path)]."""
    builds = []
    for csrc, src, lib, extra in jobs:
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        cmd = [nvcc, *flags, *extra, "-shared", "-I", csrc, os.path.join(csrc, f"{src}.cu"),
               "-o", lib]
        builds.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib))
    return builds


# the older kernels built beside this tree's: kernel -> its source (the
# older K5 is in the older K4's library, megakernel)
PREV_SOURCES = {"K4": "megakernel", "K7": "fused_bounces", "K2": "intersect",
                "K9": "regen_replay_bwd", "K8": "bounce_bwd", "K10": "bounce_step"}


def prev_jobs(csrc):
    """The older kernels' sources (PREV_SOURCES), each into its own library
    under build/prev_kernels/."""
    out = os.path.join(ROOT, "build", "prev_kernels")
    return [(csrc, src, os.path.join(out, f"libprev_{src}.so"), [])
            for src in PREV_SOURCES.values()]


# this tree's sources built again with a flag, each timed against the
# default build on the same launches: name -> (source, flags, entry point)
ALT_BUILDS = {
    # K4: a scene of one chunk takes the culled warp search instead of the
    # one-chunk scan (csrc/flat_scene.cuh flat_fits)
    "culled": ("megakernel", ["-DPT3_K4_ONE_CHUNK_CULLED"], "pt3_regen_krng"),
    # K2: the per-lane scan of a window from other numbers of agreeing
    # lanes (33: never)
    **{f"voters{v}": ("intersect", [f"-DPT3_THREAD_SCAN_VOTERS={v}"], "pt3_intersect")
       for v in (8, 12, 16, 33)},
    # K8 with its registers capped for 3 and 4 blocks of 256 an SM (the
    # default: 2)
    **{f"k8_blocks{b}": ("bounce_bwd", [f"-DPT3_K8_MIN_BLOCKS={b}"], "pt3_bounce_bwd")
       for b in (3, 4)},
    # K10: a scene of one chunk takes the culled warp search, as K4's
    # "culled"
    "k10_culled": ("bounce_step", ["-DPT3_K4_ONE_CHUNK_CULLED"], "pt3_bounce_step"),
}


def alt_jobs(csrc):
    """ALT_BUILDS' jobs, each into its own library under build/alt_kernels/."""
    out = os.path.join(ROOT, "build", "alt_kernels")
    return [(csrc, src, os.path.join(out, f"lib{name}_{src}.so"), flags)
            for name, (src, flags, _) in ALT_BUILDS.items()]


def load_alt(builds):
    """ALT_BUILDS' libraries by name, each entry point with this tree's
    signature, and their ptxas reports."""
    import ctypes

    from pt_three_ways_tpu_torch.ops import _cuda

    handles, reports = {}, []
    for (name, (src, flags, entry)), (proc, lib) in zip(ALT_BUILDS.items(), builds):
        report, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the build of {os.path.basename(lib)} failed:\n{report}")
        reports.append(f"== {src}.cu {' '.join(flags)}\n{report}")
        handles[name] = ctypes.CDLL(lib)
        fn = getattr(handles[name], entry)
        fn.argtypes = _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handles, "\n".join(reports)


class PrevKrng:
    """The older K4's entry point behind this tree's arguments: it also
    takes a replay column and a continuation's sums and counts (rcol,
    acc_in, cnt_in) after the replay slots, null here."""

    def __init__(self, lib):
        self.lib = lib

    def pt3_regen_krng(self, *args):
        return self.lib.pt3_regen_krng(*args[:22], None, None, None, *args[22:])


def load_prev(builds):
    """The older kernels' libraries by kernel (PREV_SOURCES; K5 in K4's),
    with their ptxas reports. Every entry point takes this tree's arguments
    but K10's, which takes no window boxes, and K4's (``PrevKrng``)."""
    import ctypes

    from pt_three_ways_tpu_torch.ops import _cuda

    handles, reports = {}, []
    for kernel, (proc, lib) in zip(PREV_SOURCES, builds):
        report, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the build of the older {os.path.basename(lib)} failed:\n{report}")
        reports.append(f"== {PREV_SOURCES[kernel]}.cu\n{report}")
        handles[kernel] = ctypes.CDLL(lib)
    handles["K5"] = handles["K4"]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = lambda name: (name, _cuda._SIGNATURES[name])
    k4 = _cuda._SIGNATURES["pt3_regen_krng"]
    sigs = {"K4": ("pt3_regen_krng", k4[:22] + [P, P, P] + k4[22:]),
            "K7": sig("pt3_fused_bounces"),
            "K2": sig("pt3_intersect"), "K9": sig("pt3_regen_replay_bwd"),
            "K5": sig("pt3_regen_table"), "K8": sig("pt3_bounce_bwd"),
            "K10": ("pt3_bounce_step", [P, P, P, P, I, I, I, F, F, F,
                                        P, P, P, P, P, P, I, F, I, P])}
    for kernel, (name, argtypes) in sigs.items():
        fn = getattr(handles[kernel], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handles["K4"] = PrevKrng(handles["K4"])
    return handles, "\n".join(reports)


# this tree's K4 and K7 launch functions as imported (main swaps the
# module's names for hooks and for the older kernels)
LAUNCH = {}


@contextlib.contextmanager
def swap_attr(obj, name, value):
    """obj.name replaced by value for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def prev_krng(prev, args):
    """One launch of the older K4 on the arguments of one
    ``mk._regen_krng_cuda`` call (the same entry point: the wrapper's launch
    with the older library in place); a replay launch writes its slots into
    a buffer of its own. Returns (acc, cnt, resid_out or the replay slots)."""
    import torch

    from pt_three_ways_tpu_torch.ops import _cuda

    a = list(args)
    rres = a[13] if len(a) > 13 else None
    if rres is not None:
        rres = a[13] = torch.empty_like(rres)
    with swap_attr(_cuda, "_LIB", prev["K4"]):
        acc, cnt, res = LAUNCH["K4"](*a)
    return acc, cnt, (res if rres is None else rres)


def prev_k7(prev, args):
    """One launch of the older K7 on the arguments of one
    ``mk._fused_bounces_cuda`` call; returns what that call returns."""
    from pt_three_ways_tpu_torch.ops import _cuda

    with swap_attr(_cuda, "_LIB", prev["K7"]):
        return LAUNCH["K7"](*args)


def chunk_boxes(scene, packed):
    """The culling tables of a per-thread scan over chunk boxes (the JAX
    package's): one box per 64-row chunk of the Morton-ordered triangles
    (``box_tab`` [C, 8]: lo3 hi3 pad2, the chunk's vertices, the last chunk
    padded with the last vertex) and one per FAN = 8 chunks (``box1_tab``)."""
    import torch

    f32 = torch.float32
    dev = packed.tri_tab.device
    if not packed.n_tri:
        return torch.zeros((1, 8), dtype=f32, device=dev), torch.zeros((1, 8), dtype=f32,
                                                                        device=dev)
    verts = scene.triangles.verts.to(f32).to(dev)
    pad = packed.t_pad - packed.n_tri
    if pad:
        verts = torch.cat([verts, verts[-1:, -1:, :].expand(pad, 3, 3)], dim=0)
    chunk = packed.chunk_rows
    v = verts.reshape(-1, chunk * 3, 3)
    lo, hi = v.min(dim=1).values, v.max(dim=1).values
    zeros2 = lambda k: torch.zeros((k, 2), dtype=f32, device=dev)
    n_c = lo.shape[0]
    n_l1 = -(-n_c // 8)
    inf = torch.full((n_l1 * 8 - n_c, 3), float("inf"), dtype=f32, device=dev)
    lo1 = torch.cat([lo, inf]).reshape(n_l1, 8, 3).min(dim=1).values
    hi1 = torch.cat([hi, -inf]).reshape(n_l1, 8, 3).max(dim=1).values
    return (torch.cat([lo, hi, zeros2(n_c)], dim=1).contiguous(),
            torch.cat([lo1, hi1, zeros2(n_l1)], dim=1).contiguous())


def prev_k10(prev, mk, args):
    """The older K10 on the arguments (pk, state, unif, eps, with_hit) of one
    ``mk._bounce_step_cuda`` call: what that call returns."""
    import torch

    from pt_three_ways_tpu_torch.ops import _cuda

    pk, state, unif, eps, with_hit = args
    n = state.shape[1]
    dev = state.device
    out = torch.empty((13, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    hit = ((torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev)) if with_hit else (None, None))
    err = prev["K10"].pt3_bounce_step(
        *mk._scene_ptrs(pk), state.data_ptr(), unif.data_ptr(), out.data_ptr(), cnt.data_ptr(),
        *(_cuda.ptr(h) for h in hit), n, float(eps), int(pk.no_glossy), _cuda.stream_ptr(dev))
    _cuda.check(err, "older pt3_bounce_step")
    return (out, cnt, *hit) if with_hit else (out, cnt)


def prev_k9(prev, mk, b9):
    """The older K9 on the arguments (pk, lane_ids, key_words, sample0,
    resid, cnt, acc_bar, s_count) of one ``mk.regen_replay_bwd`` call (the
    same entry point: the wrapper with the older library in place):
    (d_state0, d_mat, d_env)."""
    from pt_three_ways_tpu_torch.ops import _cuda

    with swap_attr(_cuda, "_LIB", prev["K9"]):
        return mk.regen_replay_bwd(*b9)


def ptxas_table(report):
    """One entry per kernel instance of a build report (nvcc -Xptxas -v):
    'file kernel<template args>: registers, spill bytes stored/loaded'."""
    import re

    rows, src, name, spill = [], "", "", ""
    for ln in report.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        m = re.search(r"Compiling entry function '_ZN(\w+)'", ln)
        if m:  # the last length-prefixed name before the template arguments
            rest, parts = m.group(1), []
            while rest[:1].isdigit():
                k = re.match(r"\d+", rest).group(0)
                parts.append(rest[len(k):len(k) + int(k)])
                rest = rest[len(k) + int(k):]
            t = re.match(r"I((?:L[bi]\d+E)+)E", rest)
            targs = re.findall(r"L[bi](\d+)E", t.group(1)) if t else []
            name = f"{parts[-1] if parts else m.group(1)}<{','.join(targs)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B spills"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{src} {name}: {m.group(1)} registers, {spill or '0/0 B spills'}")
            name = spill = ""
    return rows


def fmt_ms(ms) -> str:
    return "not built" if ms is None else f"{ms:.3f} ms"


def k6_occupancy(mk, args, dev):
    """The plain version of one K4 stream launch (``mk.regen_krng_plain(*args)``,
    the arguments of ``mk._regen_krng_cuda``), timed with CUDA events, with
    K6's occupancy counted from its window tests (hooks on
    ``stream_search_plain`` and ``window_enter_plain``; lanes grouped by
    ``lane // 32`` into warps and ``lane // block`` into blocks, as the
    kernel runs them). Returns (ms, outputs, counts): lane-window scans
    (the windows each ray enters), warp-window scans (the windows any of a
    warp's active lanes enters), block-window loads, block votes (the older
    flat loop: every window, each bounce of a block with a live lane; here:
    every level-1 box), block-bounces, triangle tests of the entered
    windows, box tests (level-1 and window boxes) and the windows any ray
    entered."""
    import torch

    ps, block = args[0], args[12]
    i64 = dict(dtype=torch.int64, device=dev)
    c = {k: torch.zeros((), **i64) for k in ("lane_scans", "warp_scans", "block_loads",
                                            "rows", "box_tests", "block_bounces")}
    entered = torch.zeros((ps.n_windows,), dtype=torch.bool, device=dev)
    cur = {}
    search_orig, enter_orig = mk.stream_search_plain, mk.window_enter_plain
    groups_at = ps.wbox1.untyped_storage().data_ptr()

    def count_search(pk, org, dirn, active, eps, packed_winner=True):
        cur["ids"] = active.nonzero()[:, 0]
        c["block_bounces"] += torch.unique(cur["ids"] // block).numel()
        c["box_tests"] += cur["ids"].numel() * pk.n_groups
        return search_orig(pk, org, dirn, active, eps, packed_winner)

    def count_enter(box, org, inv_d, best_t, eps, packed_winner=True):
        e = enter_orig(box, org, inv_d, best_t, eps, packed_winner)
        i = box.storage_offset() // 8
        if box.untyped_storage().data_ptr() == groups_at:  # level-1 box i
            cur["gids"] = cur["ids"][e]
            c["box_tests"] += cur["gids"].numel() * min(ps.fan, ps.n_windows - i * ps.fan)
            return e
        lanes = cur["gids"][e]  # window i
        k = lanes.numel()
        if k:
            c["lane_scans"] += k
            c["warp_scans"] += torch.unique(lanes // 32).numel()
            c["block_loads"] += torch.unique(lanes // block).numel()
            c["rows"] += k * min(ps.window, ps.n_tri - i * ps.window)
            entered[i] = True
        return e

    mk.stream_search_plain, mk.window_enter_plain = count_search, count_enter
    try:
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = mk.regen_krng_plain(*args)
        t1.record()
        torch.cuda.synchronize()
    finally:
        mk.stream_search_plain, mk.window_enter_plain = search_orig, enter_orig
    occ = {k: int(v.item()) for k, v in c.items()}
    occ["votes"] = occ["block_bounces"] * ps.n_groups
    occ["votes_flat"] = occ["block_bounces"] * ps.n_windows
    occ["windows_entered"] = int(entered.sum().item())
    return t0.elapsed_time(t1), out, occ


def culled_walk_counts(ik, mk, box, box1, fan, packed, org, dirn, live, eps):
    """The culled walk of each live ray over two-level boxes (``box`` [W, 8]:
    one a window of 64 rows; ``box1``: one per ``fan`` windows), in window
    order with the ray's running best_t (the unpacked rule: a window whose
    entry is at or beyond best_t is skipped), from the plain search. Returns
    (windows entered summed over the rays, windows any lane of a warp entered
    summed over the warps of 32 consecutive rays, live rays). A per-thread
    scan (the older K2) runs 64 test iterations a warp for each window any
    of its lanes entered; the culled warp search 2 for each (ray, window)."""
    import torch

    r = org.shape[1]
    pad = (-r) % 32
    best_t, _ = ik.sphere_search_plain(packed, org, dirn, live, eps)
    inv = mk._safe_recip(dirn)
    lane_n = torch.zeros((r + pad,), dtype=torch.int64, device=org.device)
    warp_n = torch.zeros((), dtype=torch.int64, device=org.device)
    n_win = box.shape[0]
    for g in range((n_win + fan - 1) // fan):
        en = live & mk.window_enter_plain(box1[g], org, inv, best_t, eps, False)
        if not bool(en.any()):
            continue
        for c in range(g * fan, min(g * fan + fan, n_win)):
            e = en & mk.window_enter_plain(box[c], org, inv, best_t, eps, False)
            sel = e.nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            ep = torch.cat([e, e.new_zeros(pad)])
            lane_n += ep
            warp_n += ep.reshape(-1, 32).any(dim=1).sum()
            first = c * 64
            ct, _ = ik.chunk_min_plain(packed.tri_tab[first:min(first + 64, packed.n_tri)],
                                       first, org[:, sel], dirn[:, sel], eps, False)
            best_t[sel] = torch.minimum(ct, best_t[sel])
    return lane_n.sum().item(), warp_n.item(), int(live.sum().item())


def near_walk_count(ik, mk, packed, org, dirn, live, eps):
    """Windows scanned by K2's culled search (stream_tri.cuh:
    culled_search_warp_near), summed over the live rays, from the plain
    search: the level-1 boxes in order; inside an entered one, each ray's
    entered windows nearest entry first, each scanned while its entry is
    still before the ray's best_t."""
    import torch

    best, _ = ik.sphere_search_plain(packed, org, dirn, live, eps)
    best = torch.where(live, best, torch.full_like(best, -float("inf")))
    inv = mk._safe_recip(dirn)
    scanned = torch.zeros((), dtype=torch.int64, device=org.device)
    fan, n_win = packed.fan, packed.n_windows
    for g in range(packed.n_groups):
        eg = live & mk.window_enter_plain(packed.wbox1[g], org, inv, best, eps, False)
        if not bool(eg.any()):
            continue
        sel = eg.nonzero()[:, 0]
        o, d, iv, b = org[:, sel], dirn[:, sel], inv[:, sel], best[sel]
        ws = range(g * fan, min(g * fan + fan, n_win))
        tmin, ct, todo = [], [], []
        for wi in ws:
            box = packed.wbox[wi]
            t0 = (box[0:3, None] - o) * iv
            t1 = (box[3:6, None] - o) * iv
            lo = torch.minimum(t0, t1).amax(dim=0)
            hi = torch.maximum(t0, t1).amin(dim=0)
            tmin.append(lo)
            todo.append((hi >= torch.clamp(lo, min=eps)) & (lo < b))
            first = wi * packed.window
            rows = packed.tri_tab[first:min(first + packed.window, packed.n_tri)]
            ct.append(ik.chunk_min_plain(rows, first, o, d, eps, False)[0])
        tmin, ct, todo = torch.stack(tmin), torch.stack(ct), torch.stack(todo)
        for _ in ws:
            todo &= tmin < b[None, :]
            if not bool(todo.any()):
                break
            near = torch.where(todo, tmin, torch.full_like(tmin, float("inf")))
            pick = near.argmin(dim=0)
            has = todo.any(dim=0)
            scanned += has.sum()
            cols = torch.arange(b.shape[0], device=b.device)
            b = torch.where(has, torch.minimum(b, ct[pick, cols]), b)
            todo[pick, cols] = False
        best[sel] = b
    return scanned.item()


def k9_walk_stats(cnt, aligned=False):
    """K9's walk over a lane's slots j = cnt - 1 ... 0 from the counts alone:
    (lane utilisation, 32-B sectors per 13-row load request). Utilisation is
    the lanes' slots over 32 times the slots of each warp's longest lane; a
    request is one row of one iteration of one warp, and 8 consecutive lanes
    share a sector of a row. Not ``aligned``: as the older K9 walked, lane L
    at slot cnt_L - 1 - jj in iteration jj (a group of 8 lanes reads one
    sector per distinct count); ``aligned``: the walk aligned on its warp's
    longest lane, as this K9 does (a sector is read while one of its lanes
    walks)."""
    import torch

    c = cnt.to(torch.int64)
    c = torch.cat([c, c.new_zeros((-c.shape[0]) % 32)])
    requests = max(c.reshape(-1, 32).max(dim=1).values.sum().item(), 1)
    use = c.sum().item() / (32 * requests)
    if aligned:
        return use, c.reshape(-1, 8).max(dim=1).values.sum().item() / requests
    g = torch.sort(c.reshape(-1, 8), dim=1).values
    first = torch.ones_like(g, dtype=torch.bool)
    first[:, 1:] = g[:, 1:] != g[:, :-1]
    return use, (g * first).sum().item() / requests


def phase10_ranks(train_seed):
    """Phase 10(c) on each of two ranks sharing card 0 over gloo (the
    collectives staged through host memory, parallel/mesh.py): cornell and
    suzanne 256^2 at 16 spp on a dp=2 mesh (autotune off, 8 passes a
    launch) and twice on an sp=2 mesh (the default flow), and a dp=2
    regenerating train step (S=4) on suzanne 256^2. Returns rank 0's
    results, with every rank's peak device memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pt_three_ways_tpu_torch.ops import rng
    from pt_three_ways_tpu_torch.parallel.mesh import make_mesh
    from pt_three_ways_tpu_torch.parallel.shard import render_sharded
    from pt_three_ways_tpu_torch.parallel.train import make_sharded_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    meshes = {"dp2": make_mesh(n_devices=2, dp=2, device=dev),
              "sp2": make_mesh(n_devices=2, dp=1, device=dev)}
    res = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    # the process's first launches (library load, allocator) outside the walls
    render_sharded(*phase10_scene("cornell", 64, samples_per_pixel=2, seed=1), meshes["dp2"])
    for name in ("cornell", "suzanne"):
        scene, camera, params = phase10_scene(name, 256, samples_per_pixel=16, seed=1)
        fixed = params.replace(autotune=False, passes_per_dispatch=8)
        out, wall = timed(lambda: render_sharded(scene, camera, fixed, meshes["dp2"]))
        res[f"dp2 {name}"] = (out.sum, out.count, wall)
        a, wall = timed(lambda: render_sharded(scene, camera, params, meshes["sp2"]))
        b = render_sharded(scene, camera, params, meshes["sp2"])
        res[f"sp2 {name}"] = (a.sum, a.count, wall,
                              bool(np.array_equal(a.sum, b.sum) and np.array_equal(a.count, b.count)))
    scene, camera, params = phase10_scene("suzanne", 256, seed=1)
    px, py, target, state = phase10_train_inputs(scene, camera, params, train_seed)
    step = make_sharded_train_step(scene, params, meshes["dp2"], learning_rate=0.05,
                                   passes_per_step=4)
    (loss, new), wall = timed(lambda: step(state, rng.base_key(train_seed), px, py, target))
    res["train"] = (float(loss), [m.cpu().numpy() for m in new.materials], wall)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**30)
    res["peaks"] = peaks
    return res


def phase10_scene(name, side, **kw):
    """A catalog scene at side^2 (K=16, depth 5) with its auto epsilon."""
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    params = RenderParams(width=side, height=side, **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params)
    scene = sb.build()
    return scene, camera, params.replace(epsilon=auto_epsilon(scene, camera))


def phase10_train_inputs(scene, camera, params, seed):
    """Pixels, a seeded uniform target and the first state (0.6x albedo) of
    phase 10's train steps."""
    import numpy as np
    import torch

    from pt_three_ways_tpu_torch.parallel.train import TrainState

    n, w = params.width * params.height, params.width
    px = torch.arange(n, dtype=torch.int32) % w
    py = torch.arange(n, dtype=torch.int32) // w
    target = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(n, 3)).astype(np.float32))
    mats = scene.materials._replace(diffuse=scene.materials.diffuse * 0.6)
    return px, py, target, TrainState(mats, camera, 0)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--until", type=int, default=10,
                    help="stop after this phase (default: all ten)")
    ap.add_argument("--crossover", help="after the build, only phase 8's crossover table on "
                                        "these scenes (comma-separated catalog names, "
                                        "name@16:9 for a 16:9 frame), e.g. "
                                        "suzanne-sub4,suzanne-sub5,suzanne-sub6")
    ap.add_argument("--prev", help="the csrc directory of the older K4 that prev_ms times "
                                   f"(default: build/prev_csrc, or commit {PREV_COMMIT})")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "pt_three_ways_tpu_torch")):
        print("chip_smoke: pt_three_ways_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pt_three_ways_tpu_torch.ops import _cuda
    from pt_three_ways_tpu_torch.ops import camera_kernel as ck
    from pt_three_ways_tpu_torch.ops import intersect_kernel as ik
    from pt_three_ways_tpu_torch.ops import material_grad as mg
    from pt_three_ways_tpu_torch.ops import megakernel as mk

    LAUNCH.update(K4=mk._regen_krng_cuda, K7=mk._fused_bounces_cuda)

    # ---- phase 1: card, versions, build --------------------------------
    smi = smi_line()
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"phase 1 card: {smi}")
    print(f"phase 1 versions: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}'")
    t0 = time.time()
    prev = prev_csrc(args.prev)
    side = start_builds((prev_jobs(prev) if prev else []) + alt_jobs(_cuda.CSRC),
                        _cuda.nvcc_path(), _cuda.NVCC_FLAGS)
    report = _cuda.build()
    n_alt = len(ALT_BUILDS)
    prev_lib, prev_report = load_prev(side[:-n_alt]) if prev else (None, "")
    alt_lib, alt_report = load_alt(side[-n_alt:])
    older = [r for r in ptxas_table(prev_report) if r.startswith("bounce_step.cu")]
    alt = [r for r in ptxas_table(alt_report)
           if not r.startswith("megakernel.cu") or ("K5" in r and r.split(":")[0].endswith(",1>"))]
    # registers and spills of each instance of this tree's build
    regs = dict(r.split(": ", 1) for r in ptxas_table(report))
    print(f"phase 1 build: {time.time() - t0:.1f} s (the older K2, K4, K5, K7, K8, K9 and K10 from "
          f"{prev or 'nowhere: not built'}; "
          f"this tree's again with {', '.join(f for _, fl, _ in ALT_BUILDS.values() for f in fl)}"
          f"); ptxas (registers, spill bytes stored/loaded; megakernel.cu "
          f"regen_krng_kernel<NO_GLOSSY, THRESH, RESUME, MODE, TABLE>, MODE 0 culled, 1 "
          f"replay, 2 stream, 3 one chunk, TABLE 1: K5; intersect.cu intersect_kernel<FLAT>; "
          f"bounce_step.cu bounce_step_kernel<NO_GLOSSY, WITH_HIT, FLAT>): "
          + " | ".join(ptxas_table(report)) + " || the older K10: " + " | ".join(older)
          + " || other builds (K2's voters, K5's, K8's caps, K10's culled): " + " | ".join(alt))
    _cuda.lib()

    # ---- helpers ---------------------------------------------------------
    import numpy as np

    from pt_three_ways_tpu_torch.models import integrator as integ
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
    from pt_three_ways_tpu_torch.ops import rng
    from pt_three_ways_tpu_torch.utils.png import write_png
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    def build_scene(name, w, h, **kw):
        params = RenderParams(width=w, height=h, **kw)
        sb = SceneBuilder()
        camera = create_scene(sb, name, params)
        scene = sb.build()
        params = params.replace(epsilon=auto_epsilon(scene, camera))
        return scene.to(dev), camera.to(dev), params

    def events_ms(fn, reps):
        fn()  # warm-up (and first-launch checks)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def once_ms(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    def k2_launch(a, lib=None):
        """This tree's K2 alone (or the build ``lib`` of its source) on the
        arguments (packed, org, dirn, live, eps) of one ``ik._intersect_cuda``
        call, inputs converted and outputs allocated once: (a function that
        launches it, its outputs (t, idx))."""
        packed, org, dirn, live, eps = a
        org, dirn = org.float().contiguous(), dirn.float().contiguous()
        live = live.contiguous()
        n = org.shape[1]
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        idx = torch.empty((n,), dtype=torch.int32, device=dev)
        args = (packed.tri_tab.data_ptr(), packed.sph_tab.data_ptr(), packed.n_tri,
                packed.n_sph, packed.t_pad, packed.wbox.data_ptr(), packed.wbox1.data_ptr(),
                packed.n_windows, packed.n_groups, packed.window, packed.fan, org.data_ptr(),
                dirn.data_ptr(), live.data_ptr(), t.data_ptr(), idx.data_ptr(), n, float(eps),
                _cuda.stream_ptr(dev))
        fn = (lib or _cuda.lib()).pt3_intersect
        return lambda: _cuda.check(fn(*args), "pt3_intersect"), (t, idx)

    # each wrapper's launch, and the plain version with the same signature
    launchers = {"K2": (ik, "_intersect_cuda", ik.intersect_plain),
                 "K5": (mk, "_regen_table_cuda", mk.fused_passes_plain),
                 "K4": (mk, "_regen_krng_cuda", mk.regen_krng_plain),
                 "K7": (mk, "_fused_bounces_cuda", mk.fused_bounces_plain),
                 "K8": (mk, "_bounce_bwd_cuda", mk.bounce_bwd_plain),
                 "K9": (mk, "_regen_replay_bwd_cuda", mk.regen_replay_bwd_plain),
                 "K10": (mk, "_bounce_step_cuda", mk.bounce_step_plain),
                 "K12": (mg, "_material_grad_cuda", mg.material_grad_plain)}
    wrappers = {"K2": ik.intersect_packed, "K5": mk.fused_passes, "K4": mk.fused_passes_krng,
                "K7": mk.fused_bounces, "K8": mk.bounce_bwd_step, "K9": mk.regen_replay_bwd,
                "K10": mk.bounce_step, "K11": rng.uniform_kernel, "K12": mg.material_grad,
                "K13a": ck.camera_rays, "K13b": ck.first_bounce}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        mk.fused_passes_krng.stream_launches = 0

    def read_counts():
        """Launches per kernel; K4 counts its resident launches and K6 its
        stream-mode ones."""
        out = {k: fn.launches for k, fn in wrappers.items()}
        out["K6"] = mk.fused_passes_krng.stream_launches
        out["K4"] -= out["K6"]
        out["K13"] = out.pop("K13a") + out.pop("K13b")
        return out

    @contextlib.contextmanager
    def draws_counted():
        """Counts the card's ``rng.uniforms`` calls and their elements, and
        the card's draws by the plain int64 threefry (``rng.uniform``,
        inside ``uniforms`` or not), over the block."""
        seen = {"calls": 0, "elements": 0, "plain": 0}
        orig_uniforms, orig_uniform = rng.uniforms, rng.uniform

        def uniforms(key, shape, device="cpu", dtype=torch.float32):
            if torch.device(device).type == "cuda":
                seen["calls"] += 1
                seen["elements"] += math.prod(shape)
            return orig_uniforms(key, shape, device, dtype)

        def uniform(key, shape, device="cpu", dtype=torch.float32):
            if torch.device(device).type == "cuda":
                seen["plain"] += 1
            return orig_uniform(key, shape, device, dtype)

        rng.uniforms, rng.uniform = uniforms, uniform
        try:
            yield seen
        finally:
            rng.uniforms, rng.uniform = orig_uniforms, orig_uniform

    def check_draws(seen, k11_launches, what):
        """Every card draw of ``what`` was one K11 launch: K11's count
        equals the ``uniforms`` calls, and the plain threefry drew nothing."""
        if seen["calls"] <= 0 or k11_launches != seen["calls"] or seen["plain"] != 0:
            fail(f"{what}: {k11_launches} K11 launches for {seen['calls']} card uniforms "
                 f"calls, {seen['plain']} card draws by the plain threefry")

    @contextlib.contextmanager
    def plain(kernel):
        """The wrapper runs its host-side logic as always but calls the
        kernel's plain version where it would launch the kernel."""
        mod, name, fn = launchers[kernel]
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    def first_bounce(scene, camera, params, n_passes=1):
        """First-bounce state of the camera stage (K2 inside) for n passes."""
        w, h = params.width, params.height
        px = torch.arange(w * h, device=dev, dtype=torch.int32) % w
        py = torch.arange(w * h, device=dev, dtype=torch.int32) // w
        base = rng.base_key(params.seed)
        states, unifs = [], []
        for s in range(n_passes):
            key = rng.fold_in(rng.fold_in(base, s), 0)
            st, _, un = integ._first_bounce_state(
                scene, camera, params, key, px, py, 1024, "kernel", want_unif=True)
            states.append(st)
            unifs.append(un)
        return px, py, torch.cat(states), torch.cat(unifs)

    def camera_rays(scene, camera, params):
        w, h = params.width, params.height
        px = torch.arange(w * h, device=dev, dtype=torch.int32) % w
        py = torch.arange(w * h, device=dev, dtype=torch.int32) // w
        key = rng.fold_in(rng.fold_in(rng.base_key(params.seed), 0), 0)
        u = rng.uniforms(rng.stream_key(key, rng.CAMERA_STREAM), (4, px.shape[0]), dev)
        from pt_three_ways_tpu_torch.ops.camera import generate_rays

        return generate_rays(camera, px, py, u)

    def cmp_k2(a, kw):
        """K2's wrapper on the card against the same call on its plain
        version: t and idx bit-equal (fails otherwise)."""
        t_k, i_k = ik.intersect_packed(*a, **kw)
        with plain("K2"):
            t_p, i_p = ik.intersect_packed(*a, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(t_k, t_p) and torch.equal(i_k, i_p)):
            fail(f"K2 differs from its plain version: idx agree "
                 f"{(i_k == i_p).float().mean().item()}")

    @contextlib.contextmanager
    def swapped(mod, name, fn):
        """mod.name replaced by fn (an older kernel's launch in a wrapper, or
        the culled build's library)."""
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    def pack_times(scene, mats):
        """The per-step pack of a training chain: a new PackedSceneStream
        (each step before) against ``with_materials`` on the geometry's
        pack (each step now); mean of three, ms on the host's clock."""
        mats = type(mats)(*(m.to(dev) for m in mats))
        env = scene.environment
        geo = mk.PackedSceneStream(scene)
        t = {}
        for name, fn in (("new PackedSceneStream", lambda: mk.PackedSceneStream(
                scene._replace(materials=mats))), ("with_materials", lambda: geo.with_materials(
                mats, env))):
            fn()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t[name] = (time.time() - t0) / 3 * 1e3
        return ", ".join(f"{k} {v:.2f} ms" for k, v in t.items())

    def run_culled(fn):
        """fn() with K4's launches on the culled build (ALT_BUILDS): a
        one-chunk scene takes the culled warp search."""
        with swapped(_cuda, "_LIB", alt_lib["culled"]):
            return fn()

    def k4_design(pk):
        """K4's resident design on this scene: the one-chunk scan for at most
        64 triangles (and tables within 48 KB: csrc/megakernel.cu flat_fits,
        so for every catalog scene), else the culled warp search."""
        return "one-chunk scan" if pk.n_tri <= ik.TC else "culled warp search"

    def same_out(x, y):
        """Every output of two launches bit-equal (None where absent)."""
        return all((p is None and q is None) or torch.equal(p, q) for p, q in zip(x, y))

    def cmp_acc(name, out_k, out_p):
        (acc_k, cnt_k), (acc_p, cnt_p) = out_k, out_p
        lane_ok = torch.all(torch.isclose(acc_k, acc_p, rtol=1e-4, atol=1e-5), dim=0) & (cnt_k == cnt_p)
        frac = lane_ok.float().mean().item()
        mean_k = acc_k.double().mean(dim=1)
        mean_p = acc_p.double().mean(dim=1)
        mean_ok = torch.allclose(mean_k, mean_p, rtol=1e-3, atol=1e-5)
        err = (acc_k - acc_p).abs().max().item()
        if frac < 0.99 or not mean_ok or not bool(torch.isfinite(acc_k).all()):
            fail(f"{name} disagrees with its plain version: lanes {frac}, "
                 f"means {mean_k.tolist()} vs {mean_p.tolist()}")
        return frac, err

    def pixel_grid(w, h):
        px = torch.arange(w * h, device=dev, dtype=torch.int32) % w
        py = torch.arange(w * h, device=dev, dtype=torch.int32) // w
        return px, py

    def krng_inputs(scene, camera, params, n_passes):
        """(state0 [S*10, N], lane ids) of the camera stage for n passes."""
        px, py = pixel_grid(params.width, params.height)
        base = rng.base_key(params.seed)
        states = [integ._first_bounce_state(
            scene, camera, params, rng.fold_in(rng.fold_in(base, s), 0), px, py, 1024,
            "kernel", want_unif=False)[0] for s in range(n_passes)]
        lanes = integ.lane_ids_for(px, py, params.width, params.first_bounce_samples)
        return torch.cat(states), lanes

    S8, nb8 = 8, 4

    def crossover(names):
        """K4's resident mode (the one-chunk scan or the culled warp search)
        against its stream mode (K6), against the older K4's resident mode
        (PREV_COMMIT) and, on a one-chunk scene, against the culled warp
        search (the culled build) on the same inputs: each scene at 256 wide
        (16:9 as ``name@16:9``), K=16, depth 5, S=8; acc and counts
        bit-equal; timed in turns (resident, stream, older, culled; culled,
        older, stream, resident), each over two launches after a warm-up.
        Prints one line a scene and the gate
        the table implies; returns {tag: dict(a=launch arguments, ps=pack)}."""
        from pt_three_ways_tpu_torch.models.integrator import uses_stream

        rows, out = [], {}
        for tag in names:
            name, _, aspect = tag.partition("@")
            w, h = (256, 144) if aspect == "16:9" else (256, 256)
            scene, camera, params = build_scene(name, w, h)
            route = "stream" if uses_stream(params, scene, dev) else "resident"
            state0, lanes = krng_inputs(scene, camera, params, S8)
            a = (state0, lanes, (12345, 67890), 0, params.epsilon, nb8, S8)
            ps = mk.PackedSceneStream(scene)
            kept = []
            launch = mk._regen_krng_cuda
            mk._regen_krng_cuda = lambda *x: kept.append(x) or launch(*x)
            try:
                out_r = mk.fused_passes_krng(ps, *a)
            finally:
                mk._regen_krng_cuda = launch
            out_s = mk.fused_passes_krng(ps, *a, stream=True)
            if not same_out(out_r, out_s):
                fail(f"K4 stream differs from K4 resident on {tag}")
            run_r = lambda: mk.fused_passes_krng(ps, *a)
            run_s = lambda: mk.fused_passes_krng(ps, *a, stream=True)
            run_c = lambda: run_culled(run_r)
            one_chunk = ps.n_tri <= ik.TC
            if one_chunk and not same_out(out_r, run_c()):
                fail(f"K4's culled warp search differs from the one-chunk scan on {tag}")
            runs = {"resident": run_r, "stream": run_s}
            if one_chunk:
                runs["culled"] = run_c
            same_prev = None
            older = prev_lib is not None
            if older:
                runs["older"] = lambda: prev_krng(prev_lib, kept[0])
                same_prev = same_out(out_r, runs["older"]())
                if not same_prev:
                    fail(f"K4 resident differs from the older K4 on {tag}")
            ms = {"resident": [], "stream": [], "older": [], "culled": []}
            for turn in (("resident", "stream", "older", "culled"),
                         ("culled", "older", "stream", "resident")):
                for k in turn:
                    if k in runs:
                        ms[k].append(events_ms(runs[k], 2))
            ms = {k: (sum(v) / len(v) if v else None) for k, v in ms.items()}
            rows.append((scene.num_triangles, ms["stream"] / ms["resident"]))
            print(f"phase 8 route {tag} {w}x{h}: {scene.num_triangles} triangles, Woop table "
                  f"{scene.num_triangles * mk.WOOP_ROW_BYTES / 1024:.1f} KB, {route}; "
                  f"{state0.shape[1]} lanes, K4 resident "
                  f"({k4_design(ps)}) "
                  f"{ms['resident']:.3f} ms, K4 stream {ms['stream']:.3f} ms ({ps.n_windows} "
                  f"windows of {ps.window}), stream / resident "
                  f"{ms['stream'] / ms['resident']:.3f}, the older K4's resident mode "
                  f"{fmt_ms(ms['older'])}"
                  + (f", the culled warp search {ms['culled']:.3f} ms (culled / one-chunk scan "
                     f"{ms['culled'] / ms['resident']:.3f})" if one_chunk else "")
                  + f"; acc and counts bit-equal (stream True, older K4 {same_prev}"
                  + (", culled True" if one_chunk else "") + ")", flush=True)
            out[tag] = dict(a=a, ps=ps)
            del state0, out_r, out_s, kept
        wins = [n for n, r in rows if r < 1.0]
        top = max(n for n, _ in rows)
        gate = (f"the stream mode from {min(wins)} triangles" if wins else
                f"no crossover: the resident mode at every size measured, up to {top} "
                f"triangles")
        print(f"phase 8 crossover: {gate}; the gate routes a scene of more than "
              f"RESIDENT_MAX_TRIANGLES = {mk.RESIDENT_MAX_TRIANGLES} triangles to the stream "
              f"mode (a placeholder, the largest mesh measured: no crossover sets it)",
              flush=True)
        return out

    if args.crossover:
        crossover(args.crossover.split(","))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 2: kernels vs plain versions at 256^2 ---------------------
    # K11 (ops/rng.uniforms on the card) against the plain int64 threefry on
    # the main path's own draws: a CLI-default cornell camera stage (a tile
    # of 414,720 pixels: camera and first-bounce draws) and a training pass
    # on 512^2 (camera, first bounce, and one of K7's bounce-row draws)
    k11_checks = {}
    k11_key = rng.stream_key(rng.fold_in(rng.fold_in(rng.base_key(7), 3), 1), rng.CAMERA_STREAM)
    for tag, shapes in (("cornell", [(4, 414720), (3, 414720, 16)]),
                        ("train", [(4, 262144), (3, 262144, 16), (3, 4194304)])):
        # launches: the main path's own count, phase 4's cornell render and
        # phase 6's training steps; max_abs_err 0: bit for bit, or a failure
        row = dict(launches=None, max_abs_err=0.0, ms=0.0, kernel_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, issue_floor_ms=0.0, bytes_ms=0.0, elements=0)
        for shape in shapes:
            for dtype, view in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
                got = rng.uniforms(k11_key, shape, dev, dtype)
                ref = rng.uniform(k11_key, shape, dev, dtype)
                if not torch.equal(got.view(view), ref.view(view)):
                    fail(f"K11 {shape} {dtype} differs from the plain threefry: "
                         f"{(got.view(view) != ref.view(view)).float().mean().item()} of elements")
            n = math.prod(shape)
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            k1, k2 = rng._words(k11_key)

            def alone():
                _cuda.check(_cuda.lib().pt3_threefry_uniform(
                    k1, k2, n, out.data_ptr(), 0, _cuda.stream_ptr(dev)), "pt3_threefry_uniform")

            row["kernel_ms"] += events_ms(alone, 50)
            row["ms"] += events_ms(lambda: rng.uniforms(k11_key, shape, dev), 50)
            row["plain_ms"] += events_ms(lambda: rng.uniform(k11_key, shape, dev), 3)
            row["issue_floor_ms"] += n * SASS_THREEFRY / ISSUE_PER_S * 1e3
            row["bytes_ms"] += n * 4 / PEAK_BYTES_PER_S * 1e3
            row["elements"] += n
        row["bound_ms"] = max(row["issue_floor_ms"], row["bytes_ms"])
        row["bound_by"] = "issue" if row["issue_floor_ms"] >= row["bytes_ms"] else "bytes"
        k11_checks[tag] = row
        print(f"phase 2 K11 {tag} {shapes}: float32 and float64 bit-equal to the plain "
              f"threefry; {row['elements']} float32 uniforms: kernel {row['kernel_ms']:.4f} ms "
              f"(through uniforms {row['ms']:.4f}) plain {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {SASS_THREEFRY} SASS an element "
              f"over {ISSUE_PER_S:.3g}/s; bytes {row['bytes_ms']:.4f} ms)")
    torch.cuda.empty_cache()
    for name in ("cornell", "suzanne"):
        scene, camera, params = build_scene(name, 256, 256)
        packed = ik.PackedScene(scene)
        org, dirn = camera_rays(scene, camera, params)
        k2 = ((packed, org, dirn, params.epsilon), {})
        cmp_k2(*k2)
        ms = events_ms(lambda: ik.intersect_packed(*k2[0]), 20)
        with plain("K2"):
            pms, _ = once_ms(lambda: ik.intersect_packed(*k2[0]))
        print(f"phase 2 K2 {name} 256^2: t and idx bit-equal to its plain version; "
              f"kernel {ms:.4f} ms plain {pms:.3f} ms")
    S, nb = 4, 4
    for name in ("cornell", "suzanne"):
        scene, camera, params = build_scene(name, 256, 256)
        pk = mk.PackedSceneStream(scene)  # K4's culled search reads its window boxes
        px, py, state0, unif = first_bounce(scene, camera, params, S)
        if name == "cornell":
            a = (pk, state0, mk.lane_major_table(unif, nb, S), params.epsilon, nb, S)
            out_k = mk.fused_passes(*a)
            with plain("K5"):
                out_p = mk.fused_passes(*a)
            frac, err = cmp_acc("K5", out_k, out_p)
            print(f"phase 2 K5 {name} 256^2 S={S}: lanes agree {frac:.6f} max|dacc| {err:.3e}")
        lane_ids = integ.lane_ids_for(px, py, params.width, params.first_bounce_samples)
        a = (pk, state0, lane_ids, (12345, 67890), 0, params.epsilon, nb, S)
        full = mk.fused_passes_krng(*a)
        with plain("K4"):
            out_p = mk.fused_passes_krng(*a)
        frac, err = cmp_acc("K4", full, out_p)
        # bit for bit against the plain version with the cone angles zeroed
        # (the cone sample's sinf/cosf round unlike torch's), with and
        # without tail compaction, and against the stream mode (K6)
        m = scene.materials
        pn = pk.with_materials(m._replace(cone_angle=torch.zeros_like(m.cone_angle)),
                               scene.environment)
        an = (pn,) + a[1:]
        bit = {}
        for tail in (0.0, 0.125):
            kern = mk.fused_passes_krng(*an, tail_frac=tail)
            with plain("K4"):
                ref = mk.fused_passes_krng(*an, tail_frac=tail)
            stm = mk.fused_passes_krng(*an, tail_frac=tail, stream=True)
            torch.cuda.synchronize()
            bit[tail] = same_out(kern, ref) and same_out(kern, stm)
        if not all(bit.values()):
            fail(f"K4 {name} (cone angles zeroed) differs from its plain version or the "
                 f"stream mode: {bit}")
        print(f"phase 2 K4 {name} 256^2 S={S} no_glossy={pk.no_glossy} "
              f"({k4_design(pk)}): lanes "
              f"agree {frac:.6f} max|dacc| {err:.3e}; with the cone angles zeroed bit-equal "
              f"to its plain version and to the stream mode, tail_frac 0 and 0.125: True")
        if name == "suzanne":
            at, ct = mk.fused_passes_krng(*a, tail_frac=0.125)
            torch.cuda.synchronize()
            terr = (at - full[0]).abs().max().item()
            if not torch.equal(ct, full[1]) or not torch.allclose(at, full[0], rtol=1e-6, atol=1e-6):
                fail(f"K4 tail compaction differs from the run to exhaustion: {terr}")
            print(f"phase 2 K4 suzanne tail_frac=0.125 vs exhaustion: counts equal, "
                  f"max|dacc| {terr:.3e}")

    if args.until <= 2:
        return 0

    # ---- phase 3: small-image reference against the CPU scan wavefront ----
    params = RenderParams(width=32, height=32, samples_per_pixel=2, seed=11,
                          first_bounce_u_samples=2, first_bounce_v_samples=2,
                          max_depth=4, rng_mode="table", passes_per_dispatch=2)
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params)
    scene = sb.build()
    gpu = render(scene, camera, params, device="cuda").mean()
    cpu = render(scene, camera, params, device="cpu").mean()
    pix_ok = (abs(gpu - cpu) <= 2e-4 + 2e-4 * abs(cpu)).all(axis=2)
    if pix_ok.mean() < 0.99 or abs(gpu.mean() - cpu.mean()) > 1e-3 * abs(cpu.mean()):
        fail(f"cornell 32^2 card render vs CPU scan wavefront: pixels {pix_ok.mean()}, "
             f"means {gpu.mean()} vs {cpu.mean()}")
    print(f"phase 3 reference cornell 32^2 table mode: pixels agree {pix_ok.mean():.4f}, "
          f"max|d| {float(abs(gpu - cpu).max()):.3e}, mean card {gpu.mean():.6f} "
          f"cpu {cpu.mean():.6f}")

    if args.until <= 3:
        return 0

    # ---- phase 4: the main path through render() -------------------------
    # captured[path][what]: {config: (args, kwargs)} of the first call of
    # each configuration, in call order
    captured = {}
    n_calls = {}  # n_calls[path][what]: the hooked function's calls
    rays = {"camera": 0, "bounce": torch.zeros((), dtype=torch.int64, device=dev)}
    path = {"tag": ""}
    spans = []  # (kernel, start event, end event) of every main-path launch
    restore = []

    def capture(mod, name, what, config, strip=()):
        """Keeps the first call of each configuration, without the keyword
        arguments ``strip`` names."""
        orig = getattr(mod, name)

        def hook(*a, **kw):
            kept = {k: v for k, v in kw.items() if k not in strip}
            captured[path["tag"]].setdefault(what, {}).setdefault(config(a, kw), (a, kept))
            n_calls[path["tag"]][what] = n_calls[path["tag"]].get(what, 0) + 1
            # the launch counter is an attribute of the wrapper itself
            setattr(mod, name, orig)
            try:
                return orig(*a, **kw)
            finally:
                setattr(mod, name, hook)

        setattr(mod, name, hook)
        restore.append((mod, name, orig))

    capture(ik, "intersect_packed", "K2", lambda a, kw: 0)
    capture(mk, "fused_passes", "K5", lambda a, kw: a[5])
    capture(mk, "fused_passes_krng", "K4", lambda a, kw: (a[7], kw.get("tail_frac", 0.0)))
    # per tile; without the render's state0 slice and base sum, which would
    # keep every tile's state0 alive (the stage then returns its own rows)
    capture(integ, "_first_bounce_state", "camera", lambda a, kw: int(a[5][0]),
            strip=("out", "base_sum"))

    def timed(kernel, counts_out, *a):
        """Launch with CUDA events around it; count the rays it traced."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_launch[kernel](*a)
        end.record()
        spans.append((kernel, start, end))
        if counts_out:
            rays["bounce"] += out[1].sum()
        else:
            rays["camera"] += a[1].shape[1]
        return out

    orig_launch = {k: getattr(m, n) for k, (m, n, _) in launchers.items()}
    ik._intersect_cuda = lambda *a: timed("K2", False, *a)
    mk._regen_table_cuda = lambda *a: timed("K5", True, *a)
    mk._regen_krng_cuda = lambda *a: timed("K4", True, *a)
    for k, (m, n, _) in launchers.items():
        restore.append((m, n, orig_launch[k]))

    # cornell at the CLI defaults: at 16:9 a third of its paths leave the
    # open box, so the autotune keeps the in-kernel-RNG kernel (K4); the
    # same closed scene framed square stays inside the box and autotunes to
    # the table-mode kernel (K5)
    renders = [
        ("cornell", "cornell", RenderParams(seed=1),
         ("K2", "K4", "K11", "K13")),
        ("cornell-square", "cornell", RenderParams(width=512, height=512,
                                                   samples_per_pixel=16, seed=1),
         ("K2", "K4", "K5", "K11", "K13")),
        ("suzanne", "suzanne", RenderParams(width=512, height=512,
                                            samples_per_pixel=16, seed=1),
         ("K2", "K4", "K11", "K13")),
    ]
    raw_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(raw_dir, exist_ok=True)
    launches = {}
    render_inputs = {}
    for tag, name, params, expect in renders:
        path["tag"] = tag
        captured[tag] = {}
        n_calls[tag] = {}
        sb = SceneBuilder()
        camera = create_scene(sb, name, params)
        scene = sb.build()
        params = params.replace(epsilon=auto_epsilon(scene, camera))
        render_inputs[tag] = (scene, camera, params)
        rays["camera"] = 0
        rays["bounce"].zero_()
        spans.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        with draws_counted() as seen:
            out = render(scene, camera, params, device="cuda")
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches[tag] = read_counts()
        img = out.mean()
        # .raw beside the build (a 1080p one is 58 MB); the PNG comes back
        out.save(os.path.join(raw_dir, f"{tag}.raw"))
        write_png(os.path.join(OUT_DIR, f"chip_smoke_{tag}.png"), out.to_srgb8())
        samples = out.total_samples()
        n_rays = rays["camera"] + int(rays["bounce"].item())
        mean = float(img.mean())
        if not (img.shape == (params.height, params.width, 3) and
                bool(np.isfinite(img).all()) and 0.005 < mean < 10.0):
            fail(f"{tag} render: shape {img.shape}, mean {mean}")
        for k in expect:
            if launches[tag][k] <= 0:
                fail(f"kernel {k} was not launched by the {tag} render")
        if launches[tag]["K12"] != 0:
            fail(f"the {tag} render launched K12: its table does not require grad")
        if launches[tag]["K13"] != 2 * n_calls[tag]["camera"]:
            fail(f"the {tag} render launched K13 {launches[tag]['K13']} times for "
                 f"{n_calls[tag]['camera']} camera stages (2 a stage: K13a, K13b)")
        check_draws(seen, launches[tag]["K11"], f"the {tag} render")
        kernel_ms = {}
        for k, a, b in spans:
            kernel_ms[k] = kernel_ms.get(k, 0.0) + a.elapsed_time(b)
        busy = sum(kernel_ms.values()) / (wall * 1e3)
        print(f"phase 4 render {tag} {params.width}x{params.height} spp "
              f"{params.samples_per_pixel}: {wall:.3f} s, samples/ms "
              f"{samples / (wall * 1000.0):.2f}, Mray/s {n_rays / wall / 1e6:.2f}, "
              f"mean {mean:.5f}, launches {launches[tag]}, kernel ms "
              f"{ {k: round(v, 3) for k, v in kernel_ms.items()} } "
              f"({busy:.1%} of wall), K11 drew {seen['elements']} uniforms in "
              f"{seen['calls']} uniforms calls (plain threefry on the card: {seen['plain']}), "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    k11_checks["cornell"]["launches"] = launches["cornell"]["K11"]
    for mod, name, orig in reversed(restore):
        setattr(mod, name, orig)
    spans.clear()

    if args.until <= 4:
        return 0

    # ---- phase 5: kernels vs plain on the main path's inputs, timed ------
    def bound(bytes_, ops):
        tb = bytes_ / PEAK_BYTES_PER_S * 1e3
        to = ops / PEAK_FP32_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))

    def full_scan_ops(packed):
        return packed.n_sph * OPS_SPHERE + packed.n_tri * OPS_TRIANGLE

    def search_ops(packed, org, dirn, live, t_win, eps):
        """FP32 operations of the least winner search this data needs:
        every sphere for each live ray and, where the scene has more than
        one window, the box tests (every level-1 box; the window boxes of
        each group the ray enters) and the triangles of each window whose
        box the ray enters before its winner; a one-window scene is a full
        scan."""
        org, dirn, t_win = org[:, live], dirn[:, live], t_win[live]
        r = org.shape[1]
        if packed.n_tri == 0 or packed.n_windows == 1:
            return r * full_scan_ops(packed)
        ops = r * packed.n_sph * OPS_SPHERE
        w, fan = packed.window, packed.fan
        n_w, n_g = packed.n_windows, packed.n_groups
        rows = (packed.n_tri - w * torch.arange(n_w, device=org.device)).clamp(0, w)
        in_group = (n_w - fan * torch.arange(n_g, device=org.device)).clamp(0, fan)
        tri = boxes = 0
        step = max(1, (1 << 24) // (n_w + n_g))
        for j in range(0, r, step):
            o = org[:, None, j:j + step]
            d = dirn[:, None, j:j + step]
            inv = 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))
            tw = t_win[None, j:j + step]

            def enter(tab):
                t0_ = (tab[:, 0:3].T[:, :, None] - o) * inv
                t1_ = (tab[:, 3:6].T[:, :, None] - o) * inv
                tmin = torch.minimum(t0_, t1_).amax(dim=0)
                tmax = torch.maximum(t0_, t1_).amin(dim=0)
                return (tmax >= torch.clamp(tmin, min=eps)) & (tmin < tw)

            tri += int((enter(packed.wbox).sum(dim=1) * rows).sum().item())
            boxes += int((enter(packed.wbox1).sum(dim=1) * in_group).sum().item())
        return ops + (r * n_g + boxes) * OPS_SLAB + tri * OPS_TRIANGLE

    @contextlib.contextmanager
    def counting_search(total):
        """Adds each plain winner search's least operation count to total[0]."""
        orig = mk.winner_search_plain

        def hook(pk, org, dirn, live, eps, packed_winner=False):
            t, i = orig(pk, org, dirn, live, eps, packed_winner=packed_winner)
            total[0] += search_ops(pk, org, dirn, live, t, eps)
            return t, i

        mk.winner_search_plain = hook
        try:
            yield
        finally:
            mk.winner_search_plain = orig

    def main_group(tag, what):
        """The first call of the render's last configuration (its main pass
        group, after the autotune probe)."""
        calls = captured[tag].get(what, {})
        return list(calls.values())[-1] if calls else None

    def k2_check(a):
        """This tree's K2 on one launch's arguments (packed, org, dirn, live,
        eps) against its plain version and the older K2: t and idx bit-equal
        (fails otherwise). Returns the plain version's (ms, t, idx)."""
        packed, org, dirn, live, eps = a
        fn, (t_k, i_k) = k2_launch(a)
        fn()
        pms, (t_p, i_p) = once_ms(lambda: ik.intersect_plain(packed, org.float(), dirn.float(),
                                                             live, eps))
        same = torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
        if prev_lib is not None:
            fp, (t_o, i_o) = k2_launch(a, prev_lib["K2"])
            fp()
            torch.cuda.synchronize()
            same = same and torch.equal(t_k, t_o) and torch.equal(i_k, i_o)
        if not same:
            fail(f"K2 differs from its plain version or the older K2 on a launch of "
                 f"{org.shape[1]} rays")
        return pms, t_p, i_p

    def k2_report(phase, tag, scene, a, n_launches, n_checked):
        """K2 on one launch's arguments: bit for bit against its plain
        version and the older K2; the kernels alone timed in turns (this,
        older, the voter builds on a mesh, and back; 20 launches each:
        kernel_ms, prev_kernel_ms), this one also through its wrapper,
        intersect_packed (ms); the bound from this launch's data; the test
        iterations a warp of a per-thread scan over FAN-8 chunk boxes and of
        this warp search run. Records checks['K2'][tag] and prints one line."""
        packed, org, dirn, live, eps = a
        pms, t_p, i_p = k2_check(a)
        flat = packed.n_tri <= ik.TC
        runs = {"this": k2_launch(a)[0]}
        if prev_lib is not None:
            runs["older"] = k2_launch(a, prev_lib["K2"])[0]
        voters = ""
        if not flat:  # the per-lane scan's threshold (ALT_BUILDS), bit-equal
            for v in (k for k in ALT_BUILDS if k.startswith("voters")):
                runs[v], (t_v, i_v) = k2_launch(a, alt_lib[v])
                runs[v]()
                torch.cuda.synchronize()
                if not (torch.equal(t_v, t_p) and torch.equal(i_v, i_p)):
                    fail(f"K2 built with {ALT_BUILDS[v][1][0]} differs from its plain version")
        ms = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            ms[k].append(events_ms(runs[k], 20))
        ms = {k: sum(v) / len(v) for k, v in ms.items()}
        ms.setdefault("older", None)
        if not flat:
            voters = "; the kernel alone with the per-lane scan from N voters, in turns: " \
                + ", ".join(f"{k[6:]} {v:.4f} ms" for k, v in ms.items() if k[:6] == "voters")
        ms_wrap = events_ms(lambda: ik.intersect_packed(packed, org, dirn, eps, live), 20)
        ops = search_ops(packed, org, dirn, live, t_p, eps)
        b, by = bound(nbytes(org, dirn, live, packed.tri_tab, packed.sph_tab, packed.wbox,
                             packed.wbox1) + 8 * org.shape[1], ops)
        walk = ""
        if not flat:
            lanes_o, warps_o, n_live = culled_walk_counts(ik, mk, *chunk_boxes(scene, packed), 8,
                                                          packed, *a[1:])
            lanes_n = near_walk_count(ik, mk, packed, *a[1:])
            walk = (f"; a per-thread scan over FAN-8 chunk boxes: lane utilisation "
                    f"{lanes_o / max(32 * warps_o, 1):.4f}, {lanes_o / n_live:.2f} chunks a live "
                    f"ray; this search: {lanes_n / n_live:.2f} windows a live ray, nearest first")
        checks["K2"][tag] = dict(launches=n_launches, max_abs_err=0.0, ms=ms_wrap,
                                 plain_ms=pms, bound_ms=b, bound_by=by, kernel_ms=ms["this"],
                                 prev_kernel_ms=ms["older"])
        print(f"phase {phase} K2 {tag} R={org.shape[1]} "
              f"({'one-chunk scan' if flat else 'culled warp search'}): t and idx bit-equal to "
              f"its plain version{' and the older K2' if prev_lib is not None else ''} on "
              f"{n_checked} of {n_launches} launches; "
              f"the kernel alone {ms['this']:.4f} ms in turns with the older K2 "
              f"{fmt_ms(ms['older'])}; through the wrapper {ms_wrap:.4f} ms; plain "
              f"{pms:.2f} ms; bound {b:.4f} ms ({by}){walk}{voters}", flush=True)

    def k2_check_render(scene, camera, params):
        """The render again, every K2 launch checked with k2_check; returns
        (launches checked, the first launch's arguments)."""
        orig = ik._intersect_cuda
        seen = []

        def hook(*a):
            out = orig(*a)
            seen.append(a if not seen else None)
            k2_check(a)
            return out

        with swap_attr(ik, "_intersect_cuda", hook):
            render(scene, camera, params, device="cuda")
        torch.cuda.synchronize()
        return len(seen), seen[0]

    def vs_prev_k4(a, kw):
        """The K4 wrapper call (a, kw) on this tree's kernel, on the older one
        (PREV_COMMIT) in its place and, on a one-chunk scene, on the culled
        build (the culled warp search): every kernel launch of the call (the
        continuations of tail compaction included) bit for bit, acc, counts
        and continuation state; then the call timed in turns (this, older,
        culled, culled, older, this). Returns (bit-equal to the older or
        None, ms, older ms or None, culled ms or None)."""
        kept = []
        launch = mk._regen_krng_cuda
        mk._regen_krng_cuda = lambda *x: kept.append(x) or launch(*x)
        try:
            wrappers["K4"](*a, **kw)
        finally:
            mk._regen_krng_cuda = launch
        run = lambda: wrappers["K4"](*a, **kw)
        eq = None
        if prev_lib is not None:
            eq = all(same_out(launch(*k), prev_krng(prev_lib, k)) for k in kept)
        one_chunk = a[0].n_tri <= ik.TC
        if one_chunk and not all(same_out(launch(*k), run_culled(lambda: launch(*k)))
                                 for k in kept):
            fail("K4's culled warp search differs from the one-chunk scan on a render's "
                 "launch")
        del kept

        def run_prev():
            with swapped(mk, "_regen_krng_cuda", lambda *x: prev_krng(prev_lib, x)):
                return wrappers["K4"](*a, **kw)

        others = {"older": run_prev if prev_lib is not None else None,
                  "culled": (lambda: run_culled(run)) if one_chunk else None}
        ms = {"this": [events_ms(run, 3)], "older": [], "culled": []}
        for k in ("older", "culled", "culled", "older"):
            if others[k] is not None:
                ms[k].append(events_ms(others[k], 3))
        ms["this"].append(events_ms(run, 3))
        ms = {k: (sum(v) / len(v) if v else None) for k, v in ms.items()}
        return eq, ms["this"], ms["older"], ms["culled"]

    def k5_turns(a, kw, out):
        """The K5 wrapper call (a, kw), whose outputs were ``out``, on the
        older K5 (PREV_COMMIT) in its place: acc and counts bit-equal (fails
        otherwise); the call timed in turns (this, older, older, this).
        Returns {run: ms or None}."""
        run = lambda: wrappers["K5"](*a, **kw)

        def on_lib(lib):
            def f():
                with swapped(_cuda, "_LIB", lib):
                    return run()
            return f

        runs = {"this": run, "older": on_lib(prev_lib["K5"]) if prev_lib is not None else None}
        if runs["older"] is not None and not same_out(out, runs["older"]()):
            fail("K5 differs from the older K5 on the same call")
        ms = {k: [] for k in runs}
        order = [k for k in runs if runs[k] is not None]
        for k in order + order[::-1]:
            ms[k].append(events_ms(runs[k], 3))
        return {k: (sum(v) / len(v) if v else None) for k, v in ms.items()}

    def k5_regs():
        """K5's instances' registers and spills (phase 1)."""
        return "; ".join(f"{k.split(' ', 1)[1]}: {v}" for k, v in regs.items()
                         if k.startswith("megakernel.cu regen_krng_kernel<")
                         and k.endswith(",1>"))

    @contextlib.contextmanager
    def shading_events(total):
        """Counts the plain version's shading events into total: hits, hits
        on a material with a cone angle (>= 1e-9: the glossy branch), and
        those whose event takes the cone sample (specular)."""
        orig = mk._shade_plain

        def hook(pk, st, acc, t, idx, hit, *rest):
            cone = torch.cat([pk.tri_attr[:, 29][:pk.n_tri], pk.sph_attr[:, 11][:pk.n_sph]])
            glossy = hit & (cone[idx.clamp(0, cone.numel() - 1).long()] >= mk.EPSILON)
            spec = orig(pk, st, acc, t, idx, hit, *rest)
            total[0] += hit.sum()
            total[1] += glossy.sum()
            total[2] += (glossy & spec).sum()
            return spec

        mk._shade_plain = hook
        try:
            yield
        finally:
            mk._shade_plain = orig

    checks = {"K2": {}, "K5": {}, "K4": {}}
    for tag, _, _, _ in renders:
        # K2: every launch of the render run again, checked; the first timed
        n_checked, a2 = k2_check_render(*render_inputs[tag])
        k2_report(5, tag, render_inputs[tag][0], a2, launches[tag]["K2"], n_checked)
        del a2

        for kernel in ("K5", "K4"):
            call = main_group(tag, kernel)
            if call is None:
                continue
            a, kw = call
            pk, state0 = a[0], a[1]
            out_k = wrappers[kernel](*a, **kw)
            events = torch.zeros((3,), dtype=torch.int64, device=dev)
            with plain(kernel), shading_events(events):
                pms, out_p = once_ms(lambda: wrappers[kernel](*a, **kw))
            frac, err = cmp_acc(kernel, out_k, out_p)
            extra = ""
            hits = int(events[0].item())
            if kernel == "K5":
                if not same_out(out_k, out_p):
                    fail(f"K5 on the {tag} render's main launch differs from its plain version")
                k5 = k5_turns(a, kw, out_k)
                ms, prev_ms = k5["this"], k5["older"]
                # lane utilisation one lane a thread, as K4's
                cw = out_k[1][:out_k[1].shape[0] // 32 * 32].reshape(-1, 32).to(torch.int64)
                util = cw.sum().item() / max(32 * cw.max(dim=1).values.sum().item(), 1)
                # the issue floor: SASS instructions of the events over the
                # card's issue rate (a triangle test's counted, the sphere
                # test's and the shading's at their FP32 operations)
                live = int(out_p[1].sum().item())
                floor = ((live * (pk.n_tri * SASS_TRIANGLE + pk.n_sph * OPS_SPHERE)
                          + hits * OPS_SHADE) / ISSUE_PER_S * 1e3
                         if pk.n_windows == 1 else None)
                extra = (f"; {k4_design(pk)} with the unpacked winner, lane queue: bit-equal to "
                         f"its plain version True, to the older K5 "
                         f"{prev_lib is not None or 'not built'}; in turns: this {ms:.3f} ms, "
                         f"the older K5 {fmt_ms(prev_ms)}; lane utilisation one lane a thread "
                         f"{util:.4f}; issue floor "
                         + (f"{floor:.3f} ms" if floor is not None else "n/a (culled)")
                         + f"; registers {k5_regs()}")
            else:
                same_prev, ms, prev_ms, culled_ms = vs_prev_k4(a, kw)
                if same_prev is False:
                    fail(f"K4 on the {tag} render's main launch differs from the older K4")
                # lane utilisation of the regenerating loop run one lane a
                # thread (the older K4, and this one with tail compaction):
                # per warp (32 consecutive lanes of the launch) the lanes'
                # bounces over 32 times the warp's largest count; the lane
                # queue takes back what a warp would idle
                cw = out_k[1][:out_k[1].shape[0] // 32 * 32].reshape(-1, 32).to(torch.int64)
                util = cw.sum().item() / max(32 * cw.max(dim=1).values.sum().item(), 1)
                _, glossy, cone = (int(x) for x in events.tolist())
                no_bits = pk.no_glossy and same_out(out_k, out_p)
                extra = (f"; {k4_design(pk)}, "
                         f"bit-equal to the older K4 (acc, counts, continuation state of each "
                         f"launch) {same_prev}, to its plain version "
                         f"{no_bits if pk.no_glossy else 'n/a (glossy: sinf/cosf)'}; older K4 "
                         f"{fmt_ms(prev_ms)} in turns"
                         + (f", the culled warp search (bit-equal) {culled_ms:.3f} ms in turns "
                            f"(culled / one-chunk scan {culled_ms / ms:.3f})"
                            if culled_ms is not None else "")
                         + f"; lane utilisation one lane a thread "
                         f"{util:.4f}; "
                         f"shading events {hits}: on glossy materials {glossy / max(hits, 1):.4f}, "
                         f"taking the cone sample {cone / max(hits, 1):.4f}")
                if pk.no_glossy and not no_bits:
                    fail(f"K4 on the {tag} render's main launch differs from its plain version")
            live_bounces = int(out_p[1].sum().item())
            # a bounce searches like K2 (leaves entered before its winner)
            search = [live_bounces * full_scan_ops(pk)]
            if pk.n_windows > 1 and pk.n_tri > 0:
                search = [0]
                with plain(kernel), counting_search(search):
                    wrappers[kernel](*a, **kw)
            ops = search[0] + live_bounces * OPS_SHADE
            # inputs: state0 and unif (K5) or lane ids (K4), and the scene
            bytes_ = nbytes(state0, a[2], pk.tri_tab, pk.sph_tab, pk.tri_attr,
                            pk.sph_attr) + nbytes(*out_k)
            b, by = bound(bytes_, ops)
            n, s_count = state0.shape[1], state0.shape[0] // 10
            tail = kw.get("tail_frac", 0.0)
            checks[kernel][tag] = dict(launches=launches[tag][kernel], max_abs_err=err,
                                       ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                                       prev_ms=prev_ms)
            if kernel == "K5":
                checks[kernel][tag]["issue_floor_ms"] = floor
            print(f"phase 5 {kernel} {tag} N={n} S={s_count} tail_frac={tail} "
                  f"no_glossy={pk.no_glossy}: lanes agree {frac:.6f} max|dacc| {err:.3e} "
                  f"kernel {ms:.3f} ms plain {pms:.1f} ms bound {b:.3f} ms ({by}) "
                  f"live bounces {live_bounces}{extra}")

    # the card's camera stage against the CPU's (which follows the JAX
    # package's compiled CPU rounding), on every tile of the default
    # render's first pass. The state rows are O(1) (cornell's box is two
    # units across; unit directions; throughput <= 1). A one-ulp difference
    # in a camera ray moves a near-grazing sphere hit by ~1e-5 (the sphere
    # test subtracts squares) and its mirror direction by ~1e-4, so the
    # gate is 1e-3: above rounding, far below a path that took another
    # branch or winner.
    n = n_tight = n_ok = n_pix = n_base = 0
    cam_err = card_ms = cpu_s = 0.0
    camera_calls = list(captured["cornell"]["camera"].values())
    for a, kw in camera_calls:
        ms, card = once_ms(lambda: integ._first_bounce_state(*a, **kw))
        scene, camera, params, key, px, py = a[:6]
        t0 = time.time()
        host = integ._first_bounce_state(scene.to("cpu"), camera.to("cpu"), params, key,
                                         px.cpu(), py.cpu(), *a[6:],
                                         **{k: v for k, v in kw.items() if k != "packed"})
        cpu_s += time.time() - t0
        card_ms += ms
        st_c, st_h = card[0].cpu(), host[0]
        lane_ok = torch.all(torch.isclose(st_c, st_h, rtol=1e-3, atol=1e-3), dim=0)
        n += st_c.shape[1]
        n_ok += int(lane_ok.sum())
        n_tight += int(torch.all(torch.isclose(st_c, st_h, rtol=1e-4, atol=1e-5), dim=0).sum())
        n_pix += px.shape[0]
        n_base += int(torch.all(torch.isclose(card[1].cpu(), host[1], rtol=1e-4, atol=1e-5),
                                dim=0).sum())
        if bool(lane_ok.any()):
            cam_err = max(cam_err, (st_c - st_h)[:, lane_ok].abs().max().item())
    if n_ok < 0.999 * n or n_base < 0.999 * n_pix:
        fail(f"camera stage on the card vs the CPU: lanes {n_ok / n}, pixels {n_base / n_pix}")
    print(f"phase 5 camera stage cornell, {len(captured['cornell']['camera'])} tiles, "
          f"{n_pix} pixels, {n} paths: lanes agree to 1e-3 {n_ok / n:.6f} (to rtol "
          f"1e-4/atol 1e-5 {n_tight / n:.6f}), max|d| {cam_err:.3e} on them; pixels' "
          f"base agree {n_base / n_pix:.6f}; card {card_ms:.2f} ms cpu {cpu_s * 1e3:.0f} ms")

    # K13 on the same tiles: the stage's rows and base bit for bit against
    # the eager stage on the card (its plain version), its two kernels
    # alone on the stage's own inputs (their launchers' arguments), with the
    # bytes they must move: the rows and the base written, the uniforms, the
    # pixels' rays and winners and each winning primitive's attribute row
    # read once
    k13_in = {}

    def grab(name):
        orig = getattr(ck, name)

        def hook(*a, **kw):
            k13_in[name] = a
            return orig(*a, **kw)
        return hook

    gaps = {}
    k13_ms = eager_ms = kern_ms = bytes13 = 0.0
    err13 = 0.0
    for a, kw in camera_calls:
        with swapped(ck, "_camera_rays_cuda", grab("_camera_rays_cuda")), \
                swapped(ck, "_first_bounce_cuda", grab("_first_bounce_cuda")):
            ms_k, (rows_k, base_k, _) = once_ms(lambda: integ._first_bounce_state(*a, **kw))
        with swapped(integ, "uses_camera_kernel", lambda *x: False):
            ms_e, (rows_e, base_e, _) = once_ms(lambda: integ._first_bounce_state(*a, **kw))
        k13_ms += ms_k
        eager_ms += ms_e
        for tag13, got, ref in (("row", rows_k, rows_e), ("base", base_k, base_e)):
            ref = ref.contiguous()
            for j in range(got.shape[0]):
                d = (got[j].view(torch.int32).long() - ref[j].view(torch.int32).long()).abs()
                if bool((d != 0).any()):
                    key13 = f"{tag13} {j}"
                    gaps[key13] = max(gaps.get(key13, 0), int(d.max()))
            err13 = max(err13, float((got - ref).abs().nan_to_num(0.0).max()))
        ra, fa = k13_in["_camera_rays_cuda"], k13_in["_first_bounce_cuda"]
        kern_ms += events_ms(lambda: ck._camera_rays_cuda(*ra), 20)
        kern_ms += events_ms(lambda: ck._first_bounce_cuda(*fa), 20)
        pk13, idx13, t13 = fa[0], fa[4], fa[3]
        won = torch.unique(idx13[torch.isfinite(t13)].long())
        rows_read = (int((won < pk13.n_tri).sum()) * pk13.tri_attr.shape[1]
                     + int((won >= pk13.n_tri).sum()) * pk13.sph_attr.shape[1]) * 4
        bytes13 += (nbytes(*ra) + 24 * ra[1].shape[0]  # K13a: px, py, uniforms, camera; rays
                    + nbytes(*fa[1:6], fa[7], fa[8]) + rows_read)  # K13b
    n_st = len(camera_calls)
    b13 = bytes13 / PEAK_BYTES_PER_S * 1e3 / n_st
    if gaps:
        fail(f"K13 vs the eager stage on the card: rows not bit-equal, the largest gap in "
             f"float32 steps by row: {gaps} (max|d| {err13:.3e})")
    checks["K13"] = {"cornell": dict(
        launches=launches["cornell"]["K13"], max_abs_err=err13, ms=kern_ms / n_st,
        kernel_ms=kern_ms / n_st, plain_ms=eager_ms / n_st, stage_ms=k13_ms / n_st,
        bound_ms=b13, bound_by="bytes", prev_ms=None)}
    print(f"phase 5 K13 cornell, {n_st} tiles' first stages ({n} paths): rows and base bit "
          f"for bit the eager stage's on the card; K13a + K13b alone {kern_ms / n_st:.4f} ms "
          f"a stage against a bound of {b13:.4f} ms (bytes); the stage through K13 "
          f"{k13_ms / n_st:.3f} ms, eager {eager_ms / n_st:.3f} ms (its plain version; one "
          f"call each, synchronised)")

    if args.until <= 5:
        return 0

    # ---- phase 6: the training path ---------------------------------------
    captured.clear()
    torch.cuda.empty_cache()
    from pt_three_ways_tpu_torch.models import replay
    from pt_three_ways_tpu_torch.parallel import train
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    def record():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    tparams = RenderParams(width=512, height=512, max_depth=5, seed=1)
    sb = SceneBuilder()
    tcam = create_scene(sb, "suzanne", tparams)
    tscene = sb.build()
    tparams = tparams.replace(epsilon=auto_epsilon(tscene, tcam))
    tw = tparams.width
    tpx = torch.arange(tw * tparams.height, device=dev, dtype=torch.int32) % tw
    tpy = torch.arange(tw * tparams.height, device=dev, dtype=torch.int32) // tw
    tkey = rng.base_key(7)
    # matched-RNG objective (tests/test_inverse_rendering.py): the target is
    # the scene's own image under the step's key; training starts from a
    # darker albedo
    with torch.no_grad():
        target = replay.trace_pass_replay(
            tscene.to(dev), tcam.to(dev), tparams, rng.tile_key(rng.tile_key(tkey, 0), 0),
            tpx, tpy)
    mats0 = tscene.materials._replace(diffuse=tscene.materials.diffuse * 0.6)
    step = make_sharded_train_step(tscene, tparams, learning_rate=0.05)

    # CUDA events around every launch, around the backward (train._grads),
    # and the first step's K7/K8 wrapper calls (replay's names for them)
    tspans = []
    marks = {}
    tcapt = {"K7": [], "K8": [], "K2": [], "K12": []}
    trestore = []

    def patch(mod, name, hook):
        trestore.append((mod, name, getattr(mod, name)))
        setattr(mod, name, hook)

    def span(kernel, f):
        def hook(*a):
            e0 = record()
            out = f(*a)
            tspans.append((kernel, e0, record()))
            return out
        return hook

    def capture_first(kernel, f):
        def hook(*a, **kw):
            if marks.get("step") == 0:
                tcapt[kernel].append((a, kw))
            return f(*a, **kw)
        return hook

    def grads_hook(f):
        def hook(*a):
            marks["b0"] = record()
            out = f(*a)
            marks["b1"] = record()
            return out
        return hook

    def gathers_counted(f):
        """Counts the gathers that differentiate the table (K12's calls)."""
        def hook(table, mat_id):
            if torch.is_grad_enabled() and any(x.requires_grad for x in table):
                marks["gathers"] = marks.get("gathers", 0) + 1
            return f(table, mat_id)
        return hook

    for k, (m, n, _) in launchers.items():
        if k in ("K2", "K7", "K8", "K12"):
            patch(m, n, span(k, getattr(m, n)))
    patch(mg, "_material_grad_cuda", capture_first("K12", mg._material_grad_cuda))
    patch(integ, "gather_materials", gathers_counted(integ.gather_materials))
    patch(replay, "fused_bounces", capture_first("K7", replay.fused_bounces))
    patch(replay, "bounce_bwd_step", capture_first("K8", replay.bounce_bwd_step))
    patch(train, "_grads", grads_hook(train._grads))
    patch(ik, "_intersect_cuda", capture_first("K2", ik._intersect_cuda))

    state = TrainState(mats0, tcam, 0)
    losses = []
    for fn in wrappers.values():
        fn.launches = 0
    with draws_counted() as tseen:
        for i in range(3):
            marks["step"] = i
            tspans.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            e0 = record()
            loss, state = step(state, tkey, tpx, tpy, target)
            e3 = record()
            torch.cuda.synchronize()
            wall = time.time() - t0
            kms = {k: sum(a.elapsed_time(b) for kk, a, b in tspans if kk == k)
                   for k in ("K2", "K7", "K8", "K12")}
            fwd = e0.elapsed_time(marks["b0"])
            bwd = marks["b0"].elapsed_time(marks["b1"])
            upd = marks["b1"].elapsed_time(e3)
            n8 = sum(1 for kk, _, _ in tspans if kk == "K8")
            losses.append(float(loss))
            print(f"phase 6 train step {i} suzanne 512^2 K=16 depth 5 ({tpx.shape[0] * 16} lanes): "
                  f"loss {float(loss):.6e}, wall {wall * 1e3:.1f} ms = forward {fwd:.1f} ms "
                  f"(camera stage {fwd - kms['K7'] - kms['K2']:.1f} + K2 {kms['K2']:.3f} + K7 "
                  f"{kms['K7']:.3f}) + backward {bwd:.1f} ms (camera-stage autograd "
                  f"{bwd - kms['K8'] - kms['K12']:.1f} + K12 {kms['K12']:.3f} + K8 "
                  f"{kms['K8']:.3f} in {n8} launches) + update "
                  f"{upd:.2f} ms; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    marks["step"] = None
    tlaunch = {k: fn.launches for k, fn in wrappers.items()}
    for mod, name, orig in reversed(trestore):
        setattr(mod, name, orig)
    moved = sum(float((a.cpu() - b).abs().sum()) for a, b in zip(state.materials, mats0))
    finite = all(bool(torch.isfinite(m).all()) for m in state.materials)
    if not (all(np.isfinite(losses)) and finite and moved > 0.0):
        fail(f"training: losses {losses}, finite materials {finite}, moved {moved}")
    for k in ("K2", "K7", "K8", "K11"):
        if tlaunch[k] <= 0:
            fail(f"kernel {k} was not launched by the training steps")
    if tlaunch["K13a"] + tlaunch["K13b"] != 0:
        fail(f"the training steps launched K13: {tlaunch}")
    if not tlaunch["K12"] == marks.get("gathers") == 3:
        fail(f"the training steps launched K12 {tlaunch['K12']} times for "
             f"{marks.get('gathers')} gathers that differentiate the table (3: one a pass)")
    check_draws(tseen, tlaunch["K11"], "the training steps")
    k11_checks["train"]["launches"] = tlaunch["K11"]
    print(f"phase 6 training: losses {[f'{x:.6e}' for x in losses]}, materials moved "
          f"{moved:.4e} (sum |delta|), launches {tlaunch}; K11 drew {tseen['elements']} "
          f"uniforms in {tseen['calls']} uniforms calls (plain threefry on the card: "
          f"{tseen['plain']})")

    # the per-bounce wavefront with camera gradients (K2's VJP on the card)
    ostep = make_sharded_train_step(tscene, tparams, learning_rate=0.05, fused="off",
                                    differentiate_camera=True)
    ik.intersect_packed.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    oloss, ostate = ostep(TrainState(tscene.materials, tcam, 0), tkey, tpx, tpy,
                          torch.full((tpx.shape[0], 3), 0.25, device=dev))
    torch.cuda.synchronize()
    owall = time.time() - t0
    cam_moved = sum(float((a.cpu() - b).abs().sum()) for a, b in zip(ostate.camera, tcam))
    cam_finite = all(bool(torch.isfinite(c).all()) for c in ostate.camera)
    if not (np.isfinite(float(oloss)) and cam_finite and cam_moved > 0.0
            and ik.intersect_packed.launches > 0):
        fail(f"fused='off' step: loss {float(oloss)}, camera finite {cam_finite}, "
             f"moved {cam_moved}, K2 launches {ik.intersect_packed.launches}")
    print(f"phase 6 wavefront step (fused='off', camera gradients) suzanne 512^2: loss "
          f"{float(oloss):.6e}, wall {owall * 1e3:.1f} ms, K2 launches "
          f"{ik.intersect_packed.launches}, camera moved {cam_moved:.4e}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K7 against its plain version and the older K7 (PREV_COMMIT) on the
    # first step's call; its kernel arguments kept for the older K7
    (a, kw), = tcapt["K7"]
    kept7 = []
    launch7 = mk._fused_bounces_cuda
    mk._fused_bounces_cuda = lambda *x: kept7.append(x) or launch7(*x)
    try:
        out_k = mk.fused_bounces(*a, **kw)
    finally:
        mk._fused_bounces_cuda = launch7
    with plain("K7"):
        pms, out_p = once_ms(lambda: mk.fused_bounces(*a, **kw))
    frac, err = cmp_acc("K7", out_k[:2], out_p[:2])
    same_plain7 = same_out(out_k, out_p)
    if a[0].no_glossy and not same_plain7:
        fail("K7 differs from its plain version (acc, counts, states, t, idx)")
    same_prev7 = ms7_prev = None
    if prev_lib is not None:
        same_prev7 = same_out(out_k, prev_k7(prev_lib, kept7[0]))
        if not same_prev7:
            fail("K7 differs from the older K7 (acc, counts, states, t, idx)")
    idx_ok = (out_k[4] == out_p[4]).all(dim=0) & (out_k[1] == out_p[1])
    lanes = idx_ok & torch.all(torch.isclose(out_k[0], out_p[0], rtol=1e-4, atol=1e-5), dim=0)
    t_k, t_p = out_k[3][:, lanes], out_p[3][:, lanes]
    fin = torch.isfinite(t_p)
    res_err = max((out_k[2][:, lanes] - out_p[2][:, lanes]).abs().max().item(),
                  (t_k[fin] - t_p[fin]).abs().max().item())
    if (lanes.float().mean().item() < 0.99 or not res_err <= 1e-3
            or not torch.equal(torch.isfinite(t_k), fin)):
        fail(f"K7 residuals disagree with the plain version: lanes {lanes.float().mean()}, "
             f"max |d| {res_err}")
    kern_nr = mk.fused_bounces(*a)
    with plain("K7"):
        frac_nr, err_nr = cmp_acc("K7", kern_nr, mk.fused_bounces(*a))
    run7 = lambda: mk.fused_bounces(*a, **kw)
    ms = events_ms(run7, 3)
    if prev_lib is not None:
        def run7_prev():
            with swapped(mk, "_fused_bounces_cuda", lambda *x: prev_k7(prev_lib, x)):
                return mk.fused_bounces(*a, **kw)

        ms7_prev = (events_ms(run7_prev, 3) + events_ms(run7_prev, 3)) / 2
        ms = (ms + events_ms(run7, 3)) / 2
    ms_nr = events_ms(lambda: mk.fused_bounces(*a), 3)
    pk7 = a[0]
    live7 = int(out_p[1].sum().item())
    search = [live7 * full_scan_ops(pk7)]
    if pk7.n_windows > 1 and pk7.n_tri > 0:
        search = [0]
        with plain("K7"), counting_search(search):
            mk.fused_bounces(*a, **kw)
    b7, by7 = bound(nbytes(*a[1:6], pk7.tri_tab, pk7.sph_tab, pk7.tri_attr, pk7.sph_attr)
                    + nbytes(*out_k), search[0] + live7 * OPS_SHADE)
    checks["K7"] = {"train": dict(launches=tlaunch["K7"], max_abs_err=max(err, res_err),
                                  ms=ms, plain_ms=pms, bound_ms=b7, bound_by=by7,
                                  prev_ms=ms7_prev)}
    print(f"phase 6 K7 N={a[1].shape[1]} nb={a[7]} (culled warp search): lanes agree "
          f"{frac:.6f} max|dacc| {err:.3e}, residuals on agreeing lanes max|d| {res_err:.3e} "
          f"(without residuals: lanes {frac_nr:.6f} max|dacc| {err_nr:.3e}); acc, counts, "
          f"states, t and idx bit-equal to its plain version {same_plain7} and to the older "
          f"K7 {same_prev7}; kernel {ms:.3f} ms in turns with the older K7 (windows in order) "
          f"{fmt_ms(ms7_prev)} ({ms_nr:.3f} without residuals) plain {pms:.1f} ms bound "
          f"{b7:.3f} ms ({by7}; residual bytes {nbytes(*out_k[2:]) / 1e9:.3f} GB); live "
          f"bounces {live7}")
    # the geometry's pack: built once per train step builder, its material
    # rows refreshed each step (before: a new PackedScene each step)
    packs = pack_times(tscene.to(dev), mats0)
    print(f"phase 6 geometry pack, suzanne ({tscene.num_triangles} triangles): {packs}")
    del kept7

    # K8 against its plain version on each of the first step's calls, and
    # in turns with the older K8 (PREV_COMMIT) and this K8 built with other
    # register caps (ALT_BUILDS k8_blocks*): cot_in bit-equal to theirs,
    # d_mat and d_env within 1e-5 (relative to the largest) of the plain
    # version's float64 sums and bit-identical on a second run
    def k8_device_kernels(fn):
        """Kernels one call of fn launches on the card (torch.profiler), or
        the reason it could not tell."""
        from torch.profiler import ProfilerActivity, profile

        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        except Exception as exc:  # the profiler only reports here
            return f"not measured ({type(exc).__name__})"
        return f"{len(names)} ({', '.join(sorted(set(names)))})" if names else \
            "not measured (no device events)"

    k8 = []
    for a, kw in tcapt["K8"]:
        o1 = mk.bounce_bwd_step(*a, **kw)
        o2 = mk.bounce_bwd_step(*a, **kw)
        with plain("K8"):
            op = mk.bounce_bwd_step(*a, **kw)  # (the first call also warms torch.func up)
            pms, _ = once_ms(lambda: mk.bounce_bwd_step(*a, **kw))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in zip(o1, o2))
        sc = op[0].abs().max().item()
        frac = torch.all(torch.isclose(o1[0], op[0], rtol=1e-3, atol=1e-5 * sc),
                         dim=0).float().mean().item()
        dm = (o1[1] - op[1]).abs().max().item()
        de = (o1[2] - op[2]).abs().max().item()
        gm = op[1].abs().max().item()
        ge = op[2].abs().max().item()
        rel_m, rel_e = dm / max(gm, 1e-30), de / max(ge, 1e-30)
        finite = all(bool(torch.isfinite(x).all()) for x in o1)
        if not (bitwise and finite and frac >= 0.999 and rel_m <= 1e-5 and rel_e <= 1e-5):
            fail(f"K8 disagrees with its plain version: bitwise {bitwise}, finite {finite}, "
                 f"lanes {frac}, d_mat {dm} of {gm}, d_env {de} of {ge}")
        run8 = lambda: mk.bounce_bwd_step(*a, **kw)

        def on_lib(lib):
            def f():
                with swapped(_cuda, "_LIB", lib):
                    return run8()
            return f

        runs = {"this": run8, "older": None}
        if prev_lib is not None:
            runs["older"] = on_lib(prev_lib["K8"])
        for b_ in (3, 4):
            runs[f"{b_} blocks"] = on_lib(alt_lib[f"k8_blocks{b_}"])
        vs = {}
        for k, fn in runs.items():
            if k == "this" or fn is None:
                continue
            o = fn()
            torch.cuda.synchronize()
            if not torch.equal(o[0], o1[0]):
                fail(f"K8's cot_in differs from the {k} K8's")
            vs[k] = [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
                     for x, y in zip(o1[1:], o[1:])]
            if k != "older" and not max(vs[k]) <= 1e-5:
                fail(f"K8 built for {k} an SM: d_mat / d_env {vs[k]} from this K8's")
        ms8 = {k: [] for k in runs}
        order = [k for k in runs if runs[k] is not None]
        for k in order + order[::-1]:
            ms8[k].append(events_ms(runs[k], 5))
        ms8 = {k: (sum(v) / len(v) if v else None) for k, v in ms8.items()}
        ms = ms8["this"]
        pk8, state_in, t_in = a[0], a[1], a[2]
        alive = state_in[9] != 0
        hit = alive & torch.isfinite(t_in) & (t_in > 0)
        n_hit, n_alive = int(hit.sum().item()), int(alive.sum().item())
        n_miss, n_dead = n_alive - n_hit, state_in.shape[1] - n_alive
        ops = n_hit * OPS_BWD_HIT + n_miss * OPS_BWD_MISS
        # bytes by lane class, plus the attribute tables and the sums once
        b8, by8 = bound(n_dead * BWD_BYTES_DEAD + n_miss * BWD_BYTES_MISS
                        + n_hit * BWD_BYTES_HIT + nbytes(pk8.tri_attr, pk8.sph_attr)
                        + nbytes(*o1[1:]), ops)
        k8.append(dict(ms=ms, plain_ms=pms, bound_ms=b8, bound_by=by8, prev_ms=ms8["older"],
                       max_abs_err=max((o1[0] - op[0]).abs().max().item(), dm, de)))
        launched = k8_device_kernels(run8) if len(k8) == 1 else None
        print(f"phase 6 K8 bounce {len(tcapt['K8']) - len(k8)} N={state_in.shape[1]} hit / "
              f"live miss / dead lanes {n_hit} / {n_miss} / {n_dead}: bitwise repeat {bitwise}, "
              f"cot lanes agree {frac:.6f} max|d| {(o1[0] - op[0]).abs().max().item():.3e} of "
              f"{sc:.3e}, d_mat max|d| {dm:.3e} of {gm:.3e} ({rel_m:.2e}), d_env {de:.3e} of "
              f"{ge:.3e} ({rel_e:.2e}); cot_in bit-equal to "
              + ", ".join(f"the {k} K8's (d_mat / d_env relative {v[0]:.2e} / {v[1]:.2e})"
                          for k, v in vs.items())
              + f"; in turns: this {ms:.4f} ms, the older K8 {fmt_ms(ms8['older'])}, "
              + ", ".join(f"{k} an SM {v:.4f} ms" for k, v in ms8.items() if "blocks" in k)
              + f"; plain {pms:.1f} ms bound {b8:.4f} ms ({by8})"
              + (f"; kernels a call (torch.profiler): {launched}" if launched else ""),
              flush=True)
        del o1, o2, op
    mean = lambda key: sum(r[key] for r in k8) / len(k8)
    checks["K8"] = {"train": dict(
        launches=tlaunch["K8"], max_abs_err=max(r["max_abs_err"] for r in k8),
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=max(k8, key=lambda r: r["bound_ms"])["bound_by"],
        prev_ms=mean("prev_ms") if prev_lib is not None else None)}
    print(f"phase 6 K8 mean of the {len(k8)} bounces: {mean('ms'):.4f} ms, the older K8 "
          f"{fmt_ms(checks['K8']['train']['prev_ms'])}, bound {mean('bound_ms'):.4f} ms; "
          f"registers {'; '.join(f'{k}: {v}' for k, v in regs.items() if 'bounce_bwd' in k)}",
          flush=True)
    # K12 on the first step's call (the camera stage's 262,144 lanes):
    # against its plain version and the float64 sums, bit-identical on a
    # second launch, timed through its wrapper and alone (its two kernels'
    # device time, torch.profiler) beside its bound, its plain version and
    # PyTorch's index backward (library_ms: the accumulating index_put_ of
    # each of the five loads, which autograd ran before K12; the port never
    # calls it)
    (a12, _), = tcapt["K12"]
    ids12, cot12, n_mat12 = a12
    run12 = lambda: mg.material_grad(ids12, cot12, n_mat12)
    o1, o2 = run12(), run12()
    with plain("K12"):
        pms12, op12 = once_ms(run12)
    ref12 = torch.zeros((n_mat12, 9), dtype=torch.float64, device=dev)
    sc12 = torch.zeros_like(ref12).index_add_(0, ids12.long(), cot12.T.double().abs())
    ref12.index_add_(0, ids12.long(), cot12.T.double())
    rel12 = float(((o1.double() - ref12).abs() / sc12.clamp(min=1e-30)).max())
    rel12p = float(((op12.double() - ref12).abs() / sc12.clamp(min=1e-30)).max())
    bitwise12 = torch.equal(o1, o2)
    if not (bitwise12 and rel12 <= 1e-5):
        fail(f"K12: bitwise repeat {bitwise12}, largest error {rel12} of the sum of |cot| "
             "(limit 1e-5)")
    ms12 = events_ms(run12, 50)

    def k12_kernel_ms(reps=20):
        """K12's kernels' device time a call (torch.profiler), or None."""
        from torch.profiler import ProfilerActivity, profile

        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    run12()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type.name == "CUDA" and ("material_grad_kernel" in e.name
                                                       or "reduce_columns_kernel" in e.name)]
        except Exception:  # the profiler only reports here
            return None
        return sum(us) / reps / 1e3 if len(us) == 2 * reps else None

    kms12 = k12_kernel_ms()
    m12 = ids12.long()
    rows12 = (cot12[0:3].T, cot12[3:6].T, cot12[6], cot12[7], cot12[8])
    shapes12 = ((n_mat12, 3), (n_mat12, 3), (n_mat12,), (n_mat12,), (n_mat12,))

    def index_backward():
        return [torch.zeros(sh, device=dev).index_put_((m12,), g, accumulate=True)
                for sh, g in zip(shapes12, rows12)]

    lib12 = (once_ms(index_backward)[0] + once_ms(index_backward)[0]) / 2
    b12, by12 = bound(nbytes(ids12, cot12, o1), 9 * ids12.shape[0])
    checks["K12"] = {"train": dict(
        launches=tlaunch["K12"], max_abs_err=float((o1.double() - ref12).abs().max()),
        ms=ms12, kernel_ms=kms12, plain_ms=pms12, bound_ms=b12, bound_by=by12, prev_ms=None,
        library_ms=lib12)}
    print(f"phase 6 K12 N={ids12.shape[0]} n_mat={n_mat12} (grid {mg.k12_blocks(ids12.shape[0])} "
          f"blocks): bitwise repeat {bitwise12}, largest error of the float64 sums relative "
          f"to the sum of |cot| {rel12:.2e} (the plain version's {rel12p:.2e}); through its "
          f"wrapper {ms12:.4f} ms, its two kernels alone {fmt_ms(kms12)}, bound {b12:.4f} ms "
          f"({by12}), plain {pms12:.3f} ms, PyTorch's index backward (library_ms) "
          f"{lib12:.3f} ms; launches {tlaunch['K12']} for {marks.get('gathers')} "
          f"differentiated gathers; registers "
          f"{'; '.join(f'{k}: {v}' for k, v in regs.items() if 'material_grad' in k)}",
          flush=True)
    del o1, o2, op12, ref12, sc12

    # K2: the first step's launch (every step's camera stage has the same
    # inputs: the same key, pixels and camera)
    k2_report(6, "train", tscene, tcapt["K2"][0][0], tlaunch["K2"], len(tcapt["K2"]))
    del tcapt, out_k, out_p, kern_nr

    # the card's step against the CPU's on a 32^2 crop of cornell 512^2
    cparams = RenderParams(width=512, height=512, max_depth=5, seed=1, intersector="kernel")
    sb = SceneBuilder()
    ccam = create_scene(sb, "cornell", cparams)
    cscene = sb.build()
    cparams = cparams.replace(epsilon=auto_epsilon(cscene, ccam))
    cx = torch.arange(32 * 32, dtype=torch.int32) % 32 + 240
    cy = torch.arange(32 * 32, dtype=torch.int32) // 32 + 240
    ctarget = torch.full((32 * 32, 3), 0.25)
    cstate = TrainState(cscene.materials, ccam, 0)
    outs = {}
    for where_ in ("cuda", "cpu"):
        cstep = make_sharded_train_step(cscene, cparams, learning_rate=0.05,
                                        differentiate_camera=True, device=where_)
        outs[where_] = cstep(cstate, tkey, cx, cy, ctarget)
    (lc, sc_), (lh, sh) = outs["cuda"], outs["cpu"]
    worst = {}
    for grp, new_c, new_h, old in (("materials", sc_.materials, sh.materials, cscene.materials),
                                   ("camera", sc_.camera, sh.camera, ccam)):
        for f, c, h, o in zip(new_h._fields, new_c, new_h, old):
            dc, dh = c.cpu() - o, h - o
            scale = max(dh.abs().max().item(), 1e-12)
            worst[f"{grp}.{f}"] = (dc - dh).abs().max().item() / scale
    loss_rel = abs(float(lc) - float(lh)) / abs(float(lh))
    bad = {k: v for k, v in worst.items() if v > (1e-2 if k == "materials.ior" else 1e-3)}
    if loss_rel > 1e-4 or bad:
        fail(f"card step vs CPU step on the cornell crop: loss rel {loss_rel}, updates {bad}")
    print(f"phase 6 card vs CPU train step, cornell 32^2 crop of 512^2 (16384 lanes, camera "
          f"gradients on): loss {float(lc):.6e} vs {float(lh):.6e} (rel {loss_rel:.2e}); "
          f"largest update difference relative to the field's largest update: "
          f"{max(worst.values()):.2e} ({max(worst, key=worst.get)})")

    if args.until <= 6:
        return 0

    # ---- phase 7: the regenerating training path -------------------------
    del outs, sc_, sh, ostate, state
    torch.cuda.empty_cache()
    from pt_three_ways_tpu_torch.models.replay import trace_passes_replay

    S = S_REGEN
    tscene_d, tcam_d = tscene.to(dev), tcam.to(dev)
    # matched-RNG objective: the scene's own S-pass image under the step's
    # key (samples 0..S-1, tile 0); training starts from 0.6x the albedo
    with torch.no_grad():
        rtarget = trace_passes_replay(tscene_d, tcam_d, tparams, tkey, 0, 0, tpx, tpy, S) / S
    rstep = make_sharded_train_step(tscene, tparams, learning_rate=0.05, passes_per_step=S)
    trestore.clear()
    tspans.clear()
    rcapt = {}

    def capture_regen(name, f, keep):
        """Keeps host copies of the first step's call (``keep`` picks what),
        so the later steps' memory is not held up."""
        def hook(*a, **kw):
            if marks.get("step") == 0:
                rcapt[name] = keep(a, kw)
            return f(*a, **kw)
        return hook

    host = lambda xs: [x.cpu() if torch.is_tensor(x) else x for x in xs]
    for k in ("K2", "K4", "K9"):
        m, n, _ = launchers[k]
        patch(m, n, span(k, getattr(m, n)))
    patch(replay, "fused_passes_krng", capture_regen(
        "K4", replay.fused_passes_krng, lambda a, kw: (host(a), dict(kw))))
    patch(replay, "regen_replay_bwd", capture_regen(
        "K9", replay.regen_replay_bwd, lambda a, kw: a[6].cpu()))  # acc_bar
    patch(train, "_grads", grads_hook(train._grads))
    rcapt["K2"] = []
    patch(ik, "_intersect_cuda", capture_regen(
        "K2", ik._intersect_cuda, lambda a, kw: rcapt["K2"] + [host(a)]))

    state = TrainState(mats0, tcam, 0)
    losses = []
    peaks = []
    for fn in wrappers.values():
        fn.launches = 0
    for i in range(3):
        marks["step"] = i
        tspans.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        e0 = record()
        loss, state = rstep(state, tkey, tpx, tpy, rtarget)
        e3 = record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        kms = {k: sum(a.elapsed_time(b) for kk, a, b in tspans if kk == k)
               for k in ("K2", "K4", "K9")}
        fwd = e0.elapsed_time(marks["b0"])
        bwd = marks["b0"].elapsed_time(marks["b1"])
        upd = marks["b1"].elapsed_time(e3)
        n2 = sum(1 for kk, _, _ in tspans if kk == "K2")
        losses.append(float(loss))
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"phase 7 regen train step {i} suzanne 512^2 K=16 depth 5 S={S} "
              f"({tpx.shape[0] * 16} lanes): loss {float(loss):.6e}, wall {wall * 1e3:.1f} ms "
              f"({wall * 1e3 / S:.1f} ms per pass) = forward {fwd:.1f} ms (camera stages "
              f"{fwd - kms['K4'] - kms['K2']:.1f} + K2 {kms['K2']:.3f} in {n2} launches + K4 "
              f"replay {kms['K4']:.3f}) + backward {bwd:.1f} ms (camera-stage autograd "
              f"{bwd - kms['K9']:.1f} + K9 {kms['K9']:.3f}) + update {upd:.2f} ms; peak "
              f"device memory {peaks[-1]:.2f} GiB")
    marks["step"] = None
    rlaunch = {k: fn.launches for k, fn in wrappers.items()}
    for mod, name, orig in reversed(trestore):
        setattr(mod, name, orig)
    moved = sum(float((a.cpu() - b).abs().sum()) for a, b in zip(state.materials, mats0))
    finite = all(bool(torch.isfinite(m).all()) for m in state.materials)
    if not (all(np.isfinite(losses)) and finite and moved > 0.0 and losses[2] < losses[0]):
        fail(f"regen training: losses {losses}, finite materials {finite}, moved {moved}")
    for k in ("K2", "K4", "K9"):
        if rlaunch[k] <= 0:
            fail(f"kernel {k} was not launched by the regen training steps")
    if rlaunch["K13a"] + rlaunch["K13b"] != 0:
        fail(f"the regen training steps launched K13: {rlaunch}")
    if rlaunch["K12"] != 3 * S:
        fail(f"the regen training steps launched K12 {rlaunch['K12']} times (3 x S={S}: one "
             "a camera stage)")
    print(f"phase 7 regen training: losses {[f'{x:.6e}' for x in losses]} (falling), "
          f"materials moved {moved:.4e} (sum |delta|), launches {rlaunch}")
    print(f"phase 7 geometry pack of the regen chain: {pack_times(tscene_d, mats0)}")
    del state, loss
    torch.cuda.empty_cache()

    # (a, b) K4 in replay mode as the chain runs it (culled by the window
    # boxes, no compaction): against its plain version, against K4 without
    # replay (acc and counts bit-equal) and against the older K4's replay
    # (slots, counts and acc bit-equal; timed in turns), on the first step's
    # call
    a4, kw4 = rcapt["K4"]
    a4 = [x.to(dev) if torch.is_tensor(x) else x for x in a4]
    pk4, s0_4, lanes4 = a4[0], a4[1], a4[2]
    nb4, sc4 = a4[6], a4[7]
    if not (isinstance(pk4, mk.PackedSceneStream) and kw4.get("replay")
            and not kw4.get("tail_frac")):
        fail(f"the regen chain's K4 launch is not the culled replay: {kw4}")
    kept = []  # the chain's launch, its kernel arguments kept for the older K4
    launch4 = mk._regen_krng_cuda
    mk._regen_krng_cuda = lambda *a: kept.append(a) or launch4(*a)
    try:
        out_k = mk.fused_passes_krng(*a4, **kw4)
    finally:
        mk._regen_krng_cuda = launch4
    args4 = kept[0]
    out_n = mk.fused_passes_krng(*a4)
    torch.cuda.synchronize()
    same_nr = torch.equal(out_k[0], out_n[0]) and torch.equal(out_k[1], out_n[1])
    del out_n
    cnt_k, res_k = out_k[1], out_k[2]
    acc_bar = rcapt["K9"].to(dev)
    b9 = (pk4, lanes4, a4[3], a4[4], res_k, cnt_k, acc_bar, sc4)
    same_prev4 = None
    if prev_lib is not None:
        j_col = torch.arange(sc4 * nb4, device=dev)[:, None, None]
        real = j_col < cnt_k[None, None, :]
        out_f = prev_krng(prev_lib, args4)
        torch.cuda.synchronize()
        same_prev4 = (torch.equal(out_f[1], cnt_k) and torch.equal(out_f[0], out_k[0])
                      and bool(torch.where(real, res_k == out_f[2], True).all()))
        del out_f, real
    if not (same_nr and same_prev4 is not False):
        fail(f"K4 replay culled: acc and counts bit-equal to K4 without replay {same_nr}; "
             f"slots, counts and acc bit-equal to the older K4's replay {same_prev4}")
    with plain("K4"):
        pms4, out_p = once_ms(lambda: mk.fused_passes_krng(*a4, **kw4))
    frac4, err4 = cmp_acc("K4 replay", out_k[:2], out_p[:2])
    cnt_eq = torch.equal(cnt_k, out_p[1])
    lane_ok = torch.all(torch.isclose(out_k[0], out_p[0], rtol=1e-4, atol=1e-5), dim=0) \
        & (cnt_k == out_p[1])
    res_p = out_p[2]
    res_err = 0.0
    slots = n_hit = 0
    search = 0
    for j in range(sc4 * nb4):
        m = j < cnt_k
        if not bool(m.any()):
            continue
        ok = lane_ok[m]
        rk, rp = res_k[j][:, m], res_p[j][:, m][:, ok]
        res_err = max(res_err, torch.where(rk[:, ok] == rp, 0.0, (rk[:, ok] - rp).abs())
                      .max().item())
        t_j = rk[9]
        slots += int(m.sum().item())
        n_hit += int(torch.isfinite(t_j).sum().item())
        search += search_ops(pk4, rk[0:3], rk[3:6], torch.ones_like(t_j, dtype=torch.bool),
                             t_j, a4[5])
    del out_p, res_p
    # the residual gate is K7's (phase 6): agreeing lanes' slots within 1e-3
    if not res_err <= 1e-3:
        fail(f"K4 replay: slots max|d| {res_err} against the plain version")
    # in turns: the chain's launch, the older K4 twice, the chain's launch
    run4 = lambda: mk.fused_passes_krng(*a4, **kw4)
    ms4a = events_ms(run4, 3)
    ms4_prev = None
    if prev_lib is not None:
        def run4_prev():
            with swapped(mk, "_regen_krng_cuda", lambda *x: prev_krng(prev_lib, x)):
                return mk.fused_passes_krng(*a4, **kw4)

        ms4_prev = sum(events_ms(run4_prev, 3) for _ in range(2)) / 2
    ms4b = events_ms(run4, 3)
    ms4 = (ms4a + ms4b) / 2
    ms4_nr = events_ms(lambda: mk.fused_passes_krng(*a4), 3)
    del args4, kept
    # bytes: state0, lane ids and the scene in; radiance, counts and the
    # realized slots out
    b4, by4 = bound(nbytes(s0_4, lanes4, pk4.tri_tab, pk4.sph_tab, pk4.tri_attr, pk4.sph_attr)
                    + nbytes(out_k[0], out_k[1]) + slots * REPLAY_SLOT_BYTES,
                    search + slots * OPS_SHADE)
    checks["K4r"] = {"regen-train": dict(launches=rlaunch["K4"], max_abs_err=max(err4, res_err),
                                         ms=ms4, plain_ms=pms4, bound_ms=b4, bound_by=by4,
                                         prev_ms=ms4_prev)}
    print(f"phase 7 K4 replay N={s0_4.shape[1]} S={sc4} nb={nb4} culled, no compaction, "
          f"against its plain version: lanes agree {frac4:.6f} max|dacc| {err4:.3e}, counts "
          f"equal {cnt_eq}, realized slots {slots} ({n_hit} hits) max|d| {res_err:.3e}; acc "
          f"and counts bit-equal to K4 without replay {same_nr}; slots, counts and acc "
          f"bit-equal to the older K4's replay {same_prev4}; {ms4:.3f} ms ({ms4a:.3f} / "
          f"{ms4b:.3f}; the older K4 {fmt_ms(ms4_prev)} in turns; {ms4_nr:.3f} without "
          f"replay) plain {pms4:.1f} ms bound {b4:.3f} ms ({by4}); residual buffer "
          f"{nbytes(res_k) / 1e9:.2f} GB", flush=True)

    # (c, d) K9 against its plain version, and twice, on the first step's
    # cotangent and the residuals K4 gives again for the same call
    o1 = mk.regen_replay_bwd(*b9)
    o2 = mk.regen_replay_bwd(*b9)
    torch.cuda.synchronize()
    bitwise9 = all(torch.equal(x, y) for x, y in zip(o1, o2))
    del o2
    with plain("K9"):
        pms9, op = once_ms(lambda: mk.regen_replay_bwd(*b9))
    rel = [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item() for x, y in zip(o1, op)]
    err9 = max((x - y).abs().max().item() for x, y in zip(o1, op))
    scales = [y.abs().max().item() for y in op]
    finite9 = all(bool(torch.isfinite(x).all()) for x in o1)
    del op
    if not (bitwise9 and finite9 and max(rel) <= 1e-5):
        fail(f"K9 disagrees with its plain version: bitwise {bitwise9}, finite {finite9}, "
             f"relative max|d| (d_state0, d_mat, d_env) {rel}")
    # in turns with the older K9 (PREV_COMMIT) on the same call (this, older,
    # older, this): d_state0, d_mat and d_env bit-equal to the older K9's
    run9 = lambda: mk.regen_replay_bwd(*b9)
    run9_prev = (lambda: prev_k9(prev_lib, mk, b9)) if prev_lib is not None else None
    same_prev9 = None
    if run9_prev is not None:
        o6 = run9_prev()
        torch.cuda.synchronize()
        same_prev9 = all(torch.equal(x, y) for x, y in zip(o1, o6))
        prev_rel9 = [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
                     for x, y in zip(o1[1:], o6[1:])]
        del o6
        if not same_prev9:
            fail(f"K9 differs from the older K9 (d_mat / d_env relative {prev_rel9})")
    ms9 = {"this": [], "older": []}
    for k in ("this", "older", "older", "this"):
        if k == "this" or run9_prev is not None:
            ms9[k].append(events_ms(run9 if k == "this" else run9_prev, 3))
    ms9, ms9_prev = (sum(v) / len(v) if v else None for v in (ms9["this"], ms9["older"]))
    # the walks' lane utilisation and sectors per request, from the counts
    walk, walk_prev = k9_walk_stats(cnt_k, aligned=True), k9_walk_stats(cnt_k)
    print(f"phase 7 K9 walk on the step's call: utilisation {walk[0]:.4f}, sectors a request "
          f"{walk[1]:.3f} (aligned on each warp's longest lane); the older K9's "
          f"{walk_prev[0]:.4f}, {walk_prev[1]:.3f} (4 a full coalesced warp)", flush=True)
    # what held the older K9 back, each K9 in turns: the same call with the
    # lanes (and their slots) sorted by count; with every primitive on
    # material 0 (one material's sums an iteration in the older K9); the
    # zeroed d_state0 the older K9 needs, alone
    import copy

    perm = torch.argsort(-cnt_k.to(torch.int64), stable=True)
    b9s = (pk4, lanes4[perm], a4[3], a4[4], res_k[:, :, perm], cnt_k[perm], acc_bar[:, perm], sc4)
    o_s = mk.regen_replay_bwd(*b9s)
    same_sorted = torch.equal(o_s[0], o1[0][:, perm])
    del o_s
    pk1 = copy.copy(pk4)
    pk1.tri_mat, pk1.sph_mat = torch.zeros_like(pk4.tri_mat), torch.zeros_like(pk4.sph_mat)
    b9o = (pk1,) + b9[1:]
    probe = {}
    for label, args9 in (("sorted", b9s), ("one material", b9o)):
        runs = {"this": lambda: mk.regen_replay_bwd(*args9)}
        if prev_lib is not None:
            runs["older"] = lambda: prev_k9(prev_lib, mk, args9)
        t9 = {k: [] for k in runs}
        for k in ("this", "older", "older", "this"):
            if k in runs:
                t9[k].append(events_ms(runs[k], 3))
        probe[label] = {k: sum(v) / len(v) for k, v in t9.items()}
    del b9s, b9o, pk1, perm, args9, runs
    ms_zero = events_ms(lambda: torch.zeros((sc4 * 10, lanes4.shape[0]), device=dev), 3)
    fmt_p = lambda d: (f"{d['this']:.3f} ms (the older K9 {fmt_ms(d.get('older'))})")
    print(f"phase 7 K9 probes: the lanes and their slots sorted by count: K9 "
          f"{fmt_p(probe['sorted'])}, d_state0 bit-equal, permuted: {same_sorted}; every "
          f"primitive on material 0: K9 {fmt_p(probe['one material'])} (scene materials "
          f"{pk4.n_mat}); the older K9's zeroed d_state0 alone {ms_zero:.3f} ms", flush=True)
    b9_, by9 = bound(slots * REPLAY_SLOT_BYTES + nbytes(cnt_k, lanes4, acc_bar, *o1)
                     + nbytes(pk4.tri_attr, pk4.sph_attr, pk4.tri_mat, pk4.sph_mat),
                     n_hit * OPS_BWD_HIT + (slots - n_hit) * OPS_BWD_MISS)
    checks["K9"] = {"regen-train": dict(launches=rlaunch["K9"], max_abs_err=err9, ms=ms9,
                                        plain_ms=pms9, bound_ms=b9_, bound_by=by9,
                                        prev_ms=ms9_prev)}
    print(f"phase 7 K9 N={lanes4.shape[0]} S={sc4}: bitwise repeat {bitwise9}; max|d| "
          f"relative to the largest of the plain version (float64 adjoint and sums): "
          f"d_state0 {rel[0]:.2e} (of {scales[0]:.3e}), d_mat {rel[1]:.2e} (of "
          f"{scales[1]:.3e}), d_env {rel[2]:.2e} (of {scales[2]:.3e}); against the older K9: "
          f"d_state0, d_mat and d_env bit-equal {same_prev9}; kernel "
          f"{ms9:.3f} ms in turns with the older K9 {fmt_ms(ms9_prev)}, plain {pms9:.1f} ms, "
          f"bound {b9_:.3f} ms ({by9}); hit / live-miss slots {n_hit} / {slots - n_hit}")
    # K2: the first step's eight camera stages (the later steps repeat them)
    k2_runs = [tuple(x.to(dev) if torch.is_tensor(x) else x for x in a2)
               for a2 in rcapt["K2"]]
    for a2 in k2_runs[1:]:
        k2_check(a2)
    k2_report(7, "regen-train", tscene, k2_runs[0], rlaunch["K2"], len(k2_runs))
    del o1, out_k, res_k, b9, a4, rcapt, k2_runs
    torch.cuda.empty_cache()

    # (f) trace_passes_replay forward + backward per pass, the feedback sort
    # key chained across calls (tools/bench_grad.py section 4)
    def fwd_bwd(s0, sk):
        mats = [m.detach().requires_grad_() for m in tscene_d.materials]
        sc = tscene_d._replace(materials=type(tscene_d.materials)(*mats))
        img, c = trace_passes_replay(sc, tcam_d, tparams, tkey, s0, 0, tpx, tpy, S,
                                     sort_key=sk, with_lane_counts=True)
        torch.autograd.grad(torch.mean((img / S - rtarget) ** 2), mats)
        return c

    sort_cnt = torch.zeros((tpx.shape[0] * 16,), dtype=torch.int32, device=dev)
    for i in range(2):  # warm up and seed the sort
        sort_cnt = sort_cnt + fwd_bwd(i * S, sort_cnt)
    per_pass = {}
    for label in ("sorted", "unsorted"):
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(2, 5):
            c = fwd_bwd(i * S, sort_cnt if label == "sorted" else None)
            if label == "sorted":
                sort_cnt = sort_cnt + c
        torch.cuda.synchronize()
        per_pass[label] = (time.time() - t0) / 3 / S * 1e3
    print(f"phase 7 trace_passes_replay fwd+bwd suzanne 512^2 S={S}: "
          f"{per_pass['sorted']:.1f} ms per pass with the sort key chained across calls, "
          f"{per_pass['unsorted']:.1f} ms per pass unsorted (3 calls each)")
    del sort_cnt
    torch.cuda.empty_cache()

    # (g) the card's regen step against the CPU's on a 32^2 crop of cornell
    # 512^2 (camera gradients on)
    outs = {}
    for where_ in ("cuda", "cpu"):
        cstep = make_sharded_train_step(cscene, cparams, learning_rate=0.05, passes_per_step=4,
                                        differentiate_camera=True, device=where_)
        t0 = time.time()
        outs[where_] = cstep(cstate, tkey, cx, cy, ctarget)
        outs[where_ + "_s"] = time.time() - t0
    (lc, sc_), (lh, sh) = outs["cuda"], outs["cpu"]
    worst = {}
    for grp, new_c, new_h, old in (("materials", sc_.materials, sh.materials, cscene.materials),
                                   ("camera", sc_.camera, sh.camera, ccam)):
        for f, c, h, o in zip(new_h._fields, new_c, new_h, old):
            dc, dh = c.cpu() - o, h - o
            scale = max(dh.abs().max().item(), 1e-12)
            worst[f"{grp}.{f}"] = (dc - dh).abs().max().item() / scale
    loss_rel = abs(float(lc) - float(lh)) / abs(float(lh))
    bad = {k: v for k, v in worst.items() if v > (1e-2 if k == "materials.ior" else 1e-3)}
    if loss_rel > 1e-4 or bad:
        fail(f"card regen step vs CPU on the cornell crop: loss rel {loss_rel}, updates {bad}")
    print(f"phase 7 card vs CPU regen step (passes_per_step=4), cornell 32^2 crop of 512^2 "
          f"(16384 lanes, camera gradients on): loss {float(lc):.6e} vs {float(lh):.6e} (rel "
          f"{loss_rel:.2e}); largest update difference relative to the field's largest update: "
          f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}); card {outs['cuda_s']:.2f} s "
          f"cpu {outs['cpu_s']:.2f} s")
    del outs, sc_, sh

    # the train_demo (Adam over cornell's diffuse table, 16 passes per step)
    from pt_three_ways_tpu_torch import train_demo

    demo = train_demo.run(10, 256, "cuda", log=lambda line: print(f"phase 7 train_demo {line}"))
    if not (np.isfinite([demo["loss0"], demo["loss1"]]).all() and demo["err1"] < demo["err0"]):
        fail(f"train_demo: {demo}")
    print(f"phase 7 train_demo cornell 256^2 S=16, 10 steps: observable albedo error "
          f"{demo['err0']:.4f} -> {demo['err1']:.4f} ({demo['err0'] / demo['err1']:.2f}x "
          f"reduction), loss {demo['loss0']:.6f} -> {demo['loss1']:.6f}, "
          f"{demo['ms_per_step']:.0f} ms per step ({demo['ms_per_step'] / 16:.1f} ms per pass)")

    if args.until <= 7:
        return 0

    # ---- phase 8: the stream tier (K4 stream mode, K6) and compaction (K10) -
    torch.cuda.empty_cache()
    from pt_three_ways_tpu_torch.models.integrator import (
        trace_passes_compact,
        trace_passes_fused,
        uses_stream,
    )

    # (1) routing, and K4 resident (its culled warp search; the one-chunk
    # scan on cornell) against K4 stream (K6) and the older K4 on the same
    # inputs (256 wide, S=8): cornell framed 16:9 (as the CLI default) and
    # square, and each suzanne scene
    cross = crossover(CROSSOVER_SCENES)
    keep = cross["suzanne-sub2"]
    torch.cuda.empty_cache()

    # (2) suzanne-sub2 256^2, S=8 (1,048,576 lanes): stream against resident
    # with tail compaction
    a, ps = keep["a"], keep["ps"]
    tail_r = mk.fused_passes_krng(ps, *a, tail_frac=0.125)
    tail_s = mk.fused_passes_krng(ps, *a, tail_frac=0.125, stream=True)
    torch.cuda.synchronize()
    d_tail = (tail_r[0] - tail_s[0]).abs().max().item()
    if not (torch.equal(tail_r[0], tail_s[0]) and torch.equal(tail_r[1], tail_s[1])):
        fail(f"K4 stream with tail compaction differs from resident: max|d| {d_tail}")
    print(f"phase 8 K4 stream vs resident suzanne-sub2 256^2 S={S8} "
          f"({a[0].shape[1]} lanes): max|dacc| 0 and counts equal without tail "
          f"compaction, max|dacc| {d_tail:.3e} and counts equal with tail_frac=0.125")
    del keep, cross, a, ps, tail_r, tail_s
    torch.cuda.empty_cache()

    # (3) suzanne-sub3 through render() at 512^2, 16 spp: on the route the
    # gate gives it (resident), then again with the gate lowered below its
    # triangle count, so that the render takes the stream mode (K6): its
    # pass groups, autotune probe and tail-compaction continuations. The
    # launch counters are set to 0 just before each render and read just
    # after (K4 in the one mode only; K6's launches are the stream render's).
    # The two images are bit-equal. The arguments of every K4 launch of the
    # stream render are kept for (4)
    sparams = RenderParams(width=512, height=512, samples_per_pixel=16, seed=1)
    sb = SceneBuilder()
    scam = create_scene(sb, "suzanne-sub3", sparams)
    sscene = sb.build()
    sparams = sparams.replace(epsilon=auto_epsilon(sscene, scam))

    def render_sub3(route):
        """render() of suzanne-sub3 on the route; returns (output, wall s,
        launches, CUDA-event spans, K4 launch arguments)."""
        spans8, calls = [], []

        def span8(kernel, f):
            def hook(*a):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = f(*a)
                e1.record()
                spans8.append((kernel, e0, e1))
                if kernel == "K4":
                    calls.append(a)
                return out
            return hook

        gate = mk.RESIDENT_MAX_TRIANGLES if route == "resident" else sscene.num_triangles - 1
        with contextlib.ExitStack() as stack:
            stack.enter_context(swapped(mk, "RESIDENT_MAX_TRIANGLES", gate))
            for mod, name, kernel in ((ik, "_intersect_cuda", "K2"),
                                      (mk, "_regen_krng_cuda", "K4"),
                                      (mk, "_regen_table_cuda", "K5")):
                stack.enter_context(swapped(mod, name, span8(kernel, getattr(mod, name))))
            if ("stream" if uses_stream(sparams, sscene, dev) else "resident") != route:
                fail(f"suzanne-sub3 does not route to the {route} mode")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.time()
            out = render(sscene, scam, sparams, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = read_counts()
        img = out.mean()
        mean = float(img.mean())
        if not (img.shape == (512, 512, 3) and bool(np.isfinite(img).all())
                and 0.005 < mean < 10.0):
            fail(f"suzanne-sub3 render ({route}): shape {img.shape}, mean {mean}")
        on, off = ("K6", "K4") if route == "stream" else ("K4", "K6")
        if counts[on] <= 0 or counts[off] != 0:
            fail(f"suzanne-sub3 render launches {counts}: K4 must run in its {route} mode only")
        kms = {}
        for k, e0, e1 in spans8:
            kms[k] = kms.get(k, 0.0) + e0.elapsed_time(e1)
        k4_ms = [round(e0.elapsed_time(e1), 3) for k, e0, e1 in spans8 if k == "K4"]
        print(f"phase 8 render suzanne-sub3 512x512 spp 16 ({sscene.num_triangles} triangles, "
              f"{route}{'' if route == 'resident' else ', the gate lowered to ' + str(gate)}): "
              f"{wall:.3f} s, samples/ms {out.total_samples() / (wall * 1000.0):.2f}, mean "
              f"{mean:.5f}, launches {counts}, kernel ms "
              f"{ {k: round(v, 3) for k, v in kms.items()} } ({sum(kms.values()) / (wall * 1e3):.1%} "
              f"of wall; K4 {route} by launch {k4_ms}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        return out, counts, calls

    out, launches["sub3"], _ = render_sub3("resident")
    out.save(os.path.join(raw_dir, "suzanne-sub3.raw"))
    write_png(os.path.join(OUT_DIR, "chip_smoke_suzanne-sub3.png"), out.to_srgb8())
    out_s, launches["sub3-K6"], k4_calls = render_sub3("stream")
    if not (np.array_equal(out.sum, out_s.sum) and np.array_equal(out.count, out_s.count)):
        fail(f"suzanne-sub3's stream render differs from its resident render: max|d| "
             f"{np.abs(out.sum - out_s.sum).max()}")
    print("phase 8 render suzanne-sub3: the stream render's image equals the resident "
          "render's bit for bit (radiance sums and sample counts)", flush=True)
    del out, out_s
    torch.cuda.empty_cache()
    # K2 on every launch of the sub3 render, run again (the stream render's
    # camera stages are the resident render's)
    n_checked, a2 = k2_check_render(sscene, scam, sparams)
    k2_report(8, "sub3", sscene, a2, launches["sub3"]["K2"], n_checked)
    del a2
    torch.cuda.empty_cache()

    # (4) K6 on the stream render's own launch inputs. Each launch again in
    # the stream mode and in the resident mode: acc, counts and the
    # continuation state bit-equal. Then the main pass group's first launch
    # (the one that stops its blocks for tail compaction) in the stream mode
    # against its plain version, timed, with its bound
    as_mode = lambda a, stream: a[:-1] + (stream,)
    for i, a in enumerate(k4_calls):
        o_s = mk._regen_krng_cuda(*as_mode(a, True))
        o_r = mk._regen_krng_cuda(*as_mode(a, False))
        torch.cuda.synchronize()
        if not same_out(o_s, o_r):
            fail(f"the sub3 render's K4 launch {i} in the stream mode differs from the resident "
                 f"mode on its inputs: max|dacc| {(o_s[0] - o_r[0]).abs().max().item()}")
        print(f"phase 8 K4 stream vs resident, the sub3 stream render's launch {i} "
              f"(N={a[3].shape[1]}, S={a[9]}, thresh={a[10]}, resumed={a[4] is not None}): acc, "
              f"counts{' and continuation state' if o_s[2] is not None else ''} bit-equal",
              flush=True)
        del o_s, o_r
    main6 = as_mode(next((a for a in k4_calls if a[10]), k4_calls[-1]), True)
    ps = main6[0]
    o_k = mk._regen_krng_cuda(*main6)
    pms6, o_p, occ = k6_occupancy(mk, main6, dev)
    err6 = (o_k[0] - o_p[0]).abs().max().item()
    if not same_out(o_k, o_p):
        fail(f"K4 stream disagrees with its plain version on the sub3 render's launch: "
             f"max|d| {err6}, counts equal {torch.equal(o_k[1], o_p[1])}")
    # the older K4's stream mode on the same launch: bit-equal, and timed in
    # turns with this one
    run6 = lambda: mk._regen_krng_cuda(*main6)
    ms6_prev = same_prev6 = None
    if prev_lib is not None:
        run6_prev = lambda: prev_krng(prev_lib, main6)
        o_f = run6_prev()
        torch.cuda.synchronize()
        same_prev6 = same_out(o_k, o_f)
        del o_f
        if not same_prev6:
            fail("K6 differs from the older K4's stream mode on the sub3 render's main launch")
        ms6_prev = events_ms(run6_prev, 3)
    ms6a = events_ms(run6, 3)
    ms6b = events_ms(run6, 3)
    if prev_lib is not None:
        ms6_prev = (ms6_prev + events_ms(run6_prev, 3)) / 2
    ms6 = (ms6a + ms6b) / 2
    ms6_res = events_ms(lambda: mk._regen_krng_cuda(*as_mode(main6, False)), 3)
    live6 = int(o_p[1].sum().item())
    rows6, win6 = occ["rows"], occ["windows_entered"]
    tests_sph = live6 * ps.n_sph * OPS_SPHERE
    # two bounds: the box tests PR 4's flat loop made (every window for
    # every active ray) and those of the hierarchy (the level-1 boxes, then the
    # windows of each entered group); the triangle tests are the same
    ops_flat = tests_sph + live6 * ps.n_windows * OPS_SLAB + rows6 * OPS_TRIANGLE \
        + live6 * OPS_SHADE
    ops6 = tests_sph + occ["box_tests"] * OPS_SLAB + rows6 * OPS_TRIANGLE + live6 * OPS_SHADE
    # bytes: the launch's inputs, each window some ray entered read once,
    # the boxes and attribute tables, radiance, counts and continuation out
    bytes6 = (nbytes(*main6[1:5], ps.wbox, ps.wbox1, ps.sph_tab, ps.tri_attr, ps.sph_attr)
              + win6 * ps.window * mk.WOOP_ROW_BYTES + nbytes(*o_k))
    b6, by6 = bound(bytes6, ops6)
    b6_flat, _ = bound(bytes6, ops_flat)
    checks["K6"] = {"sub3": dict(launches=launches["sub3-K6"]["K6"], max_abs_err=err6, ms=ms6,
                                 plain_ms=pms6, bound_ms=b6, bound_by=by6, prev_ms=ms6_prev)}
    print(f"phase 8 K6 occupancy on the sub3 render's main launch (N={main6[3].shape[1]}, "
          f"S={main6[9]}, thresh={main6[10]}; 64-row windows, fan {ps.fan}): lane-window scans "
          f"{occ['lane_scans']}, warp-window scans {occ['warp_scans']}, lane utilisation "
          f"{occ['lane_scans'] / max(32 * occ['warp_scans'], 1):.4f}; block-window loads "
          f"{occ['block_loads']}; block votes: {occ['votes_flat']} in PR 4's flat loop "
          f"(every window each block-bounce), {occ['votes']} group votes here; block-bounces "
          f"{occ['block_bounces']}", flush=True)
    print(f"phase 8 K4 stream vs plain, the sub3 render's main launch: max|dacc| {err6:.3e}, "
          f"counts and continuation equal, bit-equal to the older K4 {same_prev6}; kernel "
          f"{ms6:.3f} ms ({ms6a:.3f} / {ms6b:.3f}; the older K4 {fmt_ms(ms6_prev)} in turns; "
          f"the resident mode {ms6_res:.3f}) plain {pms6:.1f} ms bound {b6:.4f} ms ({by6}; "
          f"{b6_flat:.4f} with PR 4's box tests); live bounces {live6}, triangle tests in "
          f"entered windows {rows6}, windows entered {win6} of {ps.n_windows}, box tests "
          f"{occ['box_tests']} ({live6 * ps.n_windows} in the flat loop)", flush=True)
    del o_k, o_p

    # the window/fan sweep on the same launch (each bit-equal to the default)
    ref = mk._regen_krng_cuda(*main6)
    sweep6 = {}
    for window in (64, 128, 256):
        for fan in (8, 16):
            pw = mk.PackedSceneStream(sscene.to(dev), window=window, fan=fan)
            aw = (pw,) + tuple(main6[1:])
            ow = mk._regen_krng_cuda(*aw)
            torch.cuda.synchronize()
            if not same_out(ref, ow):
                fail(f"K6 at window {window}, fan {fan} differs from the default")
            sweep6[f"{window}x{fan}"] = round(events_ms(lambda: mk._regen_krng_cuda(*aw), 3), 3)
            del pw, aw, ow
    print(f"phase 8 K6 window x fan sweep on that launch (ms, each bit-equal): {sweep6}; "
          f"default {ik.WINDOW}x{ik.WINDOW_FAN}", flush=True)
    del k4_calls, main6, ps, ref, sscene
    torch.cuda.empty_cache()

    # (5) compaction (S=4) on suzanne 512^2 and (S=1) on cornell 256^2, the
    # launch counters set to 0 just before each run and read just after; the
    # first pass's K10 arguments kept
    k10_regs = {k.split(" ", 1)[1]: v for k, v in regs.items()
                if k.startswith("bounce_step.cu ")}

    def compact_run(tag, scene, camera, params, n_passes):
        px_, py_ = pixel_grid(params.width, params.height)
        calls = []
        orig = mk._bounce_step_cuda

        def hook(*a):
            if len(calls) < params.max_depth - 1:
                calls.append(a)
            return orig(*a)

        with swap_attr(mk, "_bounce_step_cuda", hook):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            out = trace_passes_compact(scene, camera, params, rng.base_key(params.seed), 0, 0,
                                       px_, py_, n_passes, with_ray_count=True)
            torch.cuda.synchronize()
            first = (time.time() - t0) * 1e3 / n_passes
            launches[tag] = read_counts()
        if launches[tag]["K10"] != n_passes * (params.max_depth - 1):
            fail(f"compaction launches {launches[tag]}")
        return out, first, calls

    def swapped_call(lib, fn):
        with swapped(_cuda, "_LIB", lib):
            return fn()

    def k10_bounces(tag, calls):
        """K10 on each bounce of a compaction pass (the permuted state, live
        lanes first; the dead tail's warps wholly dead), with and without the
        winner record: against its plain version (bit for bit; with glossy
        materials cnt, t and idx bit for bit and every lane's state within
        rtol 1e-4 / atol 1e-5), the older K10 and, on a one-chunk scene, the
        culled build (ALT_BUILDS k10_culled; bit for bit); timed in turns
        (this, older, culled, and back), with the bound. Returns one row a
        bounce."""
        rows = []
        for d, (pk, state, un, eps, _) in enumerate(calls, start=1):
            flat = pk.n_tri <= ik.TC  # K10's design as k4_design's
            runs = {"this": lambda h: mk._bounce_step_cuda(pk, state, un, eps, h),
                    "older": ((lambda h: prev_k10(prev_lib, mk, (pk, state, un, eps, h)))
                              if prev_lib is not None else None),
                    "culled": ((lambda h: swapped_call(
                        alt_lib["k10_culled"],
                        lambda: mk._bounce_step_cuda(pk, state, un, eps, h))) if flat else None)}
            for with_hit in (False, True):
                o_k = mk.bounce_step(pk, state, un, eps, with_hit=with_hit)
                with plain("K10"):
                    pms, o_p = once_ms(lambda: mk.bounce_step(pk, state, un, eps,
                                                              with_hit=with_hit))
                torch.cuda.synchronize()
                if pk.no_glossy:
                    same = same_out(o_k, o_p)
                else:
                    same = (same_out(o_k[1:], o_p[1:])
                            and torch.allclose(o_k[0], o_p[0], rtol=1e-4, atol=1e-5))
                if not same:
                    fail(f"K10 ({tag}, bounce {d}, with_hit={with_hit}) disagrees with its "
                         f"plain version: max|d| {(o_k[0] - o_p[0]).abs().max().item()}")
                for name, fn in runs.items():
                    if name != "this" and fn is not None and not same_out(o_k, fn(with_hit)):
                        fail(f"K10 ({tag}, bounce {d}, with_hit={with_hit}) differs from the "
                             f"{name} K10")
                if not with_hit:
                    pms10 = pms
            ms = {k: [] for k, fn in runs.items() if fn is not None}
            for k in list(ms) + list(ms)[::-1]:
                ms[k].append(events_ms(lambda: runs[k](False), 10))
            ms = {k: sum(v) / len(v) for k, v in ms.items()}
            msh = events_ms(lambda: runs["this"](True), 10)
            live = state[9] != 0
            n10, n_live = state.shape[1], int(live.sum().item())
            warps = -(-n10 // 32)
            pad = torch.zeros((warps * 32 - n10,), dtype=torch.bool, device=dev)
            dead_warps = warps - int(torch.cat([live, pad]).reshape(-1, 32).any(dim=1)
                                     .sum().item())
            hits = int(torch.isfinite(o_p[2]).sum().item())
            ops = search_ops(pk, state[0:3], state[3:6], live, o_p[2], eps) + hits * OPS_SHADE
            # a live lane reads its state and uniforms, a dead one its state;
            # each writes its state and count; the scene's tables once
            b, by = bound(4 * (n_live * (17 + 14) + (n10 - n_live) * (13 + 14))
                          + nbytes(pk.tri_tab, pk.sph_tab, pk.tri_attr, pk.sph_attr)
                          + (0 if flat else nbytes(pk.wbox, pk.wbox1)), ops)
            err = max((x.float() - y.float()).abs().max().item() for x, y in zip(o_k, o_p))
            rows.append(dict(ms=ms["this"], plain_ms=pms10, bound_ms=b, bound_by=by,
                             max_abs_err=err, prev_ms=ms.get("older")))
            reg = "; ".join(f"{k}: {v}" for k, v in k10_regs.items()
                            if k.endswith(f",{int(flat)}>"))
            print(f"phase 8 K10 {tag} pass 0 bounce {d} ({n10} lanes, {n_live} live first, "
                  f"{n10 - n_live} dead copied through, {dead_warps} of {warps} warps wholly "
                  f"dead, {hits} hits; {k4_design(pk)}): "
                  f"{'bit-equal' if pk.no_glossy else 'cnt, t and idx bit-equal, every state within rtol 1e-4 / atol 1e-5'} "
                  f"to its plain version, bit-equal to the older K10 "
                  f"{prev_lib is not None or 'not built'}{' and the culled build' if flat else ''}, "
                  f"with and without the winner record; in turns: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; this with the record {msh:.4f} ms; plain {pms10:.1f} ms; bound "
                  f"{b:.4f} ms ({by}); registers (bounce_step_kernel<NO_GLOSSY, WITH_HIT, "
                  f"FLAT>) {reg}", flush=True)
        mean = lambda key: sum(r[key] for r in rows) / len(rows)
        out = dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=mean("ms"),
                   plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                   bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
                   prev_ms=mean("prev_ms") if prev_lib is not None else None)
        print(f"phase 8 K10 {tag} mean of the {len(rows)} bounces: this {out['ms']:.4f} ms, "
              f"the older K10 {fmt_ms(out['prev_ms'])}, bound {out['bound_ms']:.4f} ms",
              flush=True)
        return out

    scene, camera, params = build_scene("cornell", 256, 256)
    (rad_cc, n_cc), first_cc, calls = compact_run("compact-cornell", scene, camera, params, 1)
    checks["K10"] = {"compact-cornell": dict(launches=launches["compact-cornell"]["K10"],
                                             **k10_bounces("cornell 256^2 S=1", calls))}
    del calls
    rad_5c, cnt_5c = trace_passes_fused(scene, camera, params.replace(rng_mode="table"),
                                        rng.base_key(params.seed), 0, 0,
                                        *pixel_grid(256, 256), 1, with_lane_counts=True)
    n_5c = pixel_grid(256, 256)[0].shape[0] + int(cnt_5c.sum().item())
    if not (torch.allclose(rad_cc, rad_5c, rtol=3e-4, atol=3e-4) and int(n_cc) == n_5c):
        fail(f"cornell compaction vs K5: max|d| {(rad_cc - rad_5c).abs().max().item()}, "
             f"rays {int(n_cc)} vs {n_5c}")
    print(f"phase 8 compaction cornell 256^2 K=16 depth 5 S=1: radiance within rtol/atol "
          f"3e-4 of K5's (max|d| {(rad_cc - rad_5c).abs().max().item():.3e}), rays {int(n_cc)} "
          f"equal; launches {launches['compact-cornell']}; first call {first_cc:.1f} ms",
          flush=True)
    del rad_cc, rad_5c, cnt_5c

    scene, camera, params = build_scene("suzanne", 512, 512)
    px, py = pixel_grid(512, 512)
    bkey = rng.base_key(params.seed)
    S4 = 4
    (rad_c, n_c), first_c, calls = compact_run("compact", scene, camera, params, S4)
    checks["K10"]["compact"] = dict(launches=launches["compact"]["K10"],
                                    **k10_bounces("suzanne 512^2 S=4", calls))
    del calls
    torch.cuda.empty_cache()

    # compaction against the table-mode K5 on the same keys; ms per pass of
    # compaction, K5 and K4
    pcount = {}

    def timed_call(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3 / S4, out

    pcount["compact"], _ = timed_call(lambda: trace_passes_compact(
        scene, camera, params, bkey, 0, 0, px, py, S4))
    tparams5 = params.replace(rng_mode="table")
    k5_calls = []
    launch5 = mk._regen_table_cuda
    with swap_attr(mk, "_regen_table_cuda", lambda *a: k5_calls.append(a) or launch5(*a)):
        pcount["K5"], (rad_5, cnt_5) = timed_call(lambda: trace_passes_fused(
            scene, camera, tparams5, bkey, 0, 0, px, py, S4, with_lane_counts=True))
    pcount["K4"], _ = timed_call(lambda: trace_passes_fused(
        scene, camera, params, bkey, 0, 0, px, py, S4))
    n_5 = S4 * px.shape[0] + int(cnt_5.sum().item())
    rel = ((rad_c - rad_5).abs() - 3e-4 * rad_5.abs()).max().item()
    if not (torch.allclose(rad_c, rad_5, rtol=3e-4, atol=3e-4) and int(n_c) == n_5):
        fail(f"compaction vs K5: max excess {rel}, rays {int(n_c)} vs {n_5}")
    print(f"phase 8 compaction suzanne 512^2 K=16 depth 5 S={S4}: radiance within rtol/atol "
          f"3e-4 of K5's (max|d| {(rad_c - rad_5).abs().max().item():.3e}), rays {int(n_c)} "
          f"equal; launches {launches['compact']}; ms per pass: compaction "
          f"{pcount['compact']:.1f} (first call {first_c:.1f}), K5 {pcount['K5']:.1f}, K4 "
          f"{pcount['K4']:.1f}", flush=True)
    del rad_c, rad_5, cnt_5

    # K5's culled warp search on that call (the table-mode run's launch):
    # bit for bit against its plain version and the older K5, timed in
    # turns, with its bound
    pk5, state5, _, unif5, eps5, nb5, sc5 = k5_calls[-1]
    a5 = (pk5, state5, unif5, eps5, nb5, sc5)  # the wrapper's arguments
    out_5 = wrappers["K5"](*a5)
    with plain("K5"):
        pms5, out_p5 = once_ms(lambda: wrappers["K5"](*a5))
    if not same_out(out_5, out_p5):
        fail("K5's culled warp search differs from its plain version on suzanne")
    k5 = k5_turns(a5, {}, out_5)
    search5 = [0]
    with plain("K5"), counting_search(search5):
        wrappers["K5"](*a5)
    live5 = int(out_p5[1].sum().item())
    b5, by5 = bound(nbytes(state5, a5[2], pk5.tri_tab, pk5.sph_tab, pk5.tri_attr, pk5.sph_attr,
                           pk5.wbox, pk5.wbox1) + nbytes(*out_5),
                    search5[0] + live5 * OPS_SHADE)
    checks["K5"]["compact-table"] = dict(
        launches=1, max_abs_err=0.0, ms=k5["this"], plain_ms=pms5, bound_ms=b5,
        bound_by=by5, prev_ms=k5["older"])
    print(f"phase 8 K5 suzanne 512^2 S={S4} N={state5.shape[1]} (table mode, culled warp "
          f"search, lane queue): acc and counts bit-equal to its plain version and to the "
          f"older K5 {prev_lib is not None or 'not built'}; in turns: this "
          f"{k5['this']:.3f} ms, the older K5 {fmt_ms(k5['older'])}; plain {pms5:.1f} ms "
          f"bound {b5:.3f} ms ({by5}); live bounces {live5}", flush=True)
    del a5, out_5, out_p5, k5_calls, scene

    # ---- phase 9: the other ways, smallpt, remat, the CLI and the merge ---
    if args.until >= 9:
        t9 = time.time()
        torch.cuda.empty_cache()
        from pt_three_ways_tpu_torch import cli as port_cli
        from pt_three_ways_tpu_torch.models import smallpt as sp
        from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput, merge, srgb8
        from pt_three_ways_tpu_torch.utils.png import read_png

        # (a) the ways through render() at the CLI default, 1 spp (phase 9
        # keeps the whole run within about a minute of phases 1-8): K2 on
        # the camera rays and on every substratum and bounce of oo and fp
        wparams = RenderParams(samples_per_pixel=1, seed=1, fused="off")
        sb = SceneBuilder()
        wcam = create_scene(sb, "cornell", wparams)
        wscene = sb.build()
        wparams = wparams.replace(epsilon=auto_epsilon(wscene, wcam))
        k_sub, nb9 = wparams.first_bounce_samples, wparams.max_depth - 1
        images, first = {}, {}
        for way in ("dod", "oo", "fp"):
            per_pass = 1 + (nb9 if way == "dod" else k_sub * nb9)
            calls, spans9 = [], []
            launch = ik._intersect_cuda

            def k2_hook(*a, calls=calls, spans9=spans9, per_pass=per_pass, launch=launch):
                if len(calls) < per_pass:  # the first tile-pass's launches
                    calls.append(a)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = launch(*a)
                e1.record()
                spans9.append((e0, e1))
                return out

            ik._intersect_cuda = k2_hook
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.time()
                out = render(wscene, wcam, wparams, way=way, device="cuda")
                torch.cuda.synchronize()
                wall = time.time() - t0
                counts9 = read_counts()
            finally:
                ik._intersect_cuda = launch
            peak = torch.cuda.max_memory_allocated() / 2**30
            k2_ms = sum(a.elapsed_time(b) for a, b in spans9)
            img = out.mean()
            images[way] = img
            if not (img.shape == (wparams.height, wparams.width, 3)
                    and bool(np.isfinite(img).all())):
                fail(f"the {way} render is not finite or has the wrong shape")
            if counts9["K2"] <= 0:
                fail(f"K2 was not launched by the {way} render")
            dead = next((a for a in calls[1:] if not bool(a[3].all())), None)
            if dead is None:
                fail(f"no launch of the {way} render's first tile-pass has dead lanes")
            k2_check(dead)  # bit for bit against its plain version and the older K2
            if way == "dod":
                k2_check(calls[0])  # oo's and fp's first launches: k2_report below
            n_dead = int((~dead[3]).sum().item())
            first[way] = (calls[0], counts9["K2"])
            samples = out.total_samples()
            err = float(np.abs(img - images["dod"]).max())
            if err > 2e-5:
                fail(f"the {way} render differs from the dod scan wavefront by {err:.3e}")
            print(f"phase 9 render {way} cornell {wparams.width}x{wparams.height} K={k_sub} "
                  f"depth {wparams.max_depth} spp {wparams.samples_per_pixel} (fused='off'): "
                  f"{wall:.3f} s, samples/ms "
                  f"{samples / (wall * 1000.0):.2f}, peak device memory {peak:.2f} GiB, "
                  f"launches {counts9}, K2 {k2_ms:.3f} ms summed over its launches, CUDA events "
                  f"around each ({k2_ms / counts9['K2']:.4f} ms a launch; {calls[0][1].shape[1]} "
                  f"rays a camera launch, {calls[1][1].shape[1]} a bounce launch), "
                  f"mean {float(img.mean()):.5f}, max|image - dod| {err:.3e}; K2 bit-equal to "
                  f"its plain version on a bounce launch with {n_dead} dead lanes", flush=True)
        del calls
        for way in ("oo", "fp"):
            a9, n9 = first[way]
            k2_report(9, way, wscene, a9, n9, 2)
        del first, images

        # (b) smallpt on the card
        t0 = time.time()
        simg = sp.render_smallpt(1920, 1080, 4, seed=1, max_bounces=40, device="cuda")
        swall = time.time() - t0
        if not (simg.shape == (1080, 1920, 3) and np.isfinite(simg).all()
                and (simg >= 0).all() and (simg <= 1).all()):
            fail("the smallpt render is not finite in [0, 1]")
        write_png(os.path.join(OUT_DIR, "chip_smoke_smallpt.png"), srgb8(simg))
        r9 = np.random.default_rng(1234)
        o9 = torch.tensor(r9.uniform(0, 100, (3, 2048)), dtype=torch.float32, device=dev)
        d9 = torch.tensor(r9.normal(size=(3, 2048)), dtype=torch.float64, device=dev)
        d9 = (d9 / d9.norm(dim=0)).float()
        t_c, i_c = sp._intersect(sp.smallpt_scene(device=dev), o9, d9)
        sc = sp.smallpt_scene(torch.float64, dev)
        op = sc.centre[:, :, None] - o9.double()[None]
        b9 = (op * d9.double()[None]).sum(1)
        r2 = torch.tensor([s[0] ** 2 for s in sp._SPHERES], dtype=torch.float64, device=dev)
        det = b9 * b9 - (op * op).sum(1) + r2[:, None]
        sq = torch.sqrt(torch.clamp(det, min=0))
        tt = torch.where(b9 - sq > sp.EPS, b9 - sq, b9 + sq)
        tt = torch.where((det >= 0) & (tt > sp.EPS), tt, torch.full_like(tt, float("inf")))
        best, idx9 = tt.min(dim=0)
        hit = torch.isfinite(best)
        idx_ok = (i_c[hit].long() == idx9[hit]).double().mean().item()
        terr = (t_c[hit].double() - best[hit]).abs()
        t_mean, t_p995 = terr.mean().item(), torch.quantile(terr, 0.995).item()
        if not (idx_ok > 0.999 and t_mean < 0.02 and t_p995 < 0.05):
            fail(f"smallpt _intersect on the card against the float64 oracle: index "
                 f"{idx_ok}, mean |dt| {t_mean}, 99.5th percentile {t_p995}")
        small_c = sp.render_smallpt(64, 48, 4, seed=1, device="cuda")
        small_h = sp.render_smallpt(64, 48, 4, seed=1, device="cpu")
        close = float(np.all(np.abs(small_c - small_h) <= 1e-5, axis=2).mean())
        sdiff = float(np.abs(small_c - small_h).max())
        rel = abs(small_c.mean() - small_h.mean()) / small_h.mean()
        if rel > 1e-3:
            fail(f"smallpt 64x48: the card's image mean differs from the CPU's by {rel:.3e}")
        print(f"phase 9 smallpt 1920x1080 spp 4 (one a subpixel), 40 bounces: {swall:.3f} s, "
              f"samples/ms {1920 * 1080 * 4 / (swall * 1000.0):.2f}, mean {simg.mean():.5f}; "
              f"_intersect on 2048 rays against a float64 oracle on the card: index agree "
              f"{idx_ok:.4f}, mean |dt| {t_mean:.3e}, 99.5th percentile {t_p995:.3e}; 64x48 "
              f"card vs CPU: pixels within 1e-5 {close:.4f}, max|d| {sdiff:.3e}, image means "
              f"{small_c.mean():.6f} / {small_h.mean():.6f} (rel {rel:.2e})", flush=True)
        del simg

        # (c) the fused="off" train step: dod, dod with remat, oo, and dod and
        # oo again with each material row's gradient summed in float64
        tparams9 = RenderParams(width=512, height=512, max_depth=5, seed=1)
        sb = SceneBuilder()
        tcam9 = create_scene(sb, "suzanne", tparams9)
        tscene9 = sb.build()
        tparams9 = tparams9.replace(epsilon=auto_epsilon(tscene9, tcam9))
        tpx9, tpy9 = pixel_grid(512, 512)
        target9 = torch.full((tpx9.shape[0], 3), 0.25, device=dev)
        grads9 = {}
        grads_of = train._grads
        gather32 = integ.gather_materials

        def gather64(table, mat_id):
            """The same float32 values, gathered from a float64 copy of the
            table: the backward then sums each row's gradient over the lanes
            in float64 and rounds it once (the forward is unchanged)."""
            g = gather32(type(table)(*(m.double() for m in table)), mat_id)
            return integ.GatheredMat(*(f.float() for f in g))

        def rel_to(tag, ref):
            return [float((g - g0).norm() / torch.clamp(g0.norm(), min=1e-30))
                    for g, g0 in zip(grads9[tag], grads9[ref])]

        for tag, way, remat, f64 in (("dod", "dod", False, False),
                                     ("dod remat", "dod", True, False),
                                     ("oo", "oo", False, False),
                                     ("dod f64 sums", "dod", False, True),
                                     ("oo f64 sums", "oo", False, True)):
            step9 = make_sharded_train_step(tscene9, tparams9.replace(remat=remat), way=way,
                                            learning_rate=0.05, fused="off")
            st0 = TrainState(tscene9.materials, tcam9, 0)
            if remat:  # torch.utils.checkpoint's one-time set-up (seconds), on 256 pixels
                step9(st0, rng.base_key(7), tpx9[:256], tpy9[:256], target9[:256])
            ik.intersect_packed.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            got = []
            e0.record()
            with swapped(train, "_grads", lambda *a: got.append(grads_of(*a)) or got[-1]), \
                    swapped(integ, "gather_materials", gather64 if f64 else gather32):
                loss9, _ = step9(st0, rng.base_key(7), tpx9, tpy9, target9)
            e1.record()
            torch.cuda.synchronize()
            ms9 = e0.elapsed_time(e1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            grads9[tag] = [g.double() for g in got[0]]
            if not all(bool(torch.isfinite(g).all()) for g in grads9[tag]):
                fail(f"train step {tag}: a gradient is not finite")
            ref = "dod f64 sums" if tag == "oo f64 sums" else "dod"
            print(f"phase 9 train step {tag} (fused='off') suzanne 512^2 K=16 depth 5: loss "
                  f"{float(loss9):.6e}, {ms9:.1f} ms, peak device memory {peak:.2f} GiB "
                  f"({peak - held:.2f} above the {held:.2f} held before the step), K2 "
                  f"launches {ik.intersect_packed.launches}; gradients against {ref}'s, "
                  "|d| / |g|: " + ", ".join(
                      f"{n} {r:.2e}" for n, r in zip(tscene9.materials._fields,
                                                     rel_to(tag, ref))), flush=True)
        # A material row's gradient is a float32 sum over ~4 M lanes a
        # bounce, in another order in each way. Its rounding is what each
        # way's float32 sums differ from its own float64 sums by; with the
        # sums in float64 the ways agree to 1e-5 of the norm, and in float32
        # they may differ by no more than 1e-5 plus the two ways' rounding.
        names9 = tscene9.materials._fields
        gates9 = [("dod remat", "dod", [1e-5] * len(names9)),
                  ("oo f64 sums", "dod f64 sums", [1e-5] * len(names9)),
                  ("oo", "dod", [1e-5 + a + b for a, b in zip(rel_to("dod", "dod f64 sums"),
                                                             rel_to("oo", "oo f64 sums"))])]
        for tag, ref, lims in gates9:
            for name, r, lim in zip(names9, rel_to(tag, ref), lims):
                if r > lim:
                    fail(f"train step {tag}: the {name} gradient differs from {ref}'s by "
                         f"{r:.3e} of its norm (limit {lim:.3e})")
        print("phase 9 train step float32 rounding of the lane sums, |float32 - float64 "
              "sums| / |g|: dod " + ", ".join(
                  f"{n} {r:.2e}" for n, r in zip(names9, rel_to("dod", "dod f64 sums")))
              + "; oo " + ", ".join(
                  f"{n} {r:.2e}" for n, r in zip(names9, rel_to("oo", "oo f64 sums")))
              + "; oo against dod within " + ", ".join(
                  f"{n} {lim:.2e}" for n, lim in zip(names9, gates9[2][2])), flush=True)
        del grads9, step9

        # (d) two CLI runs of the oo way, merged by raw_to_png
        import io

        raws, lines9 = [], []
        for seed in (1, 2):
            raws.append(os.path.join(raw_dir, f"oo_{seed}.raw"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = port_cli.main(["-w", "256", "-h", "256", "--spp", "2", "--seed", str(seed),
                                    "--way", "oo", "--save-every", "0", "--raw", raws[-1]])
            if rc != 0:
                fail(f"the CLI (--way oo, seed {seed}) exited {rc}")
            lines9.append(" / ".join(buf.getvalue().splitlines()))
        merged = os.path.join(OUT_DIR, "chip_smoke_oo_merged.png")
        proc = subprocess.run([sys.executable, "-m", "pt_three_ways_tpu_torch.raw_to_png",
                               merged, *raws], capture_output=True, text=True, timeout=120,
                              cwd=ROOT)
        if proc.returncode != 0:
            fail(f"raw_to_png exited {proc.returncode}: {proc.stderr[-500:]}")
        want = merge([ArrayOutput.load(r) for r in raws]).to_srgb8()
        if not np.array_equal(read_png(merged), want):
            fail("raw_to_png's PNG differs from to_srgb8() of the merge")
        print(f"phase 9 CLI --way oo 256^2 spp 2, seeds 1 and 2: {' | '.join(lines9)}; "
              f"raw_to_png: {' / '.join(proc.stdout.splitlines())}; its PNG equals "
              f"to_srgb8() of the merge", flush=True)
        print(f"phase 9: {time.time() - t9:.1f} s", flush=True)

    # ---- phase 10: the native host library and the mesh --------------------
    if args.until >= 10:
        t10 = time.time()
        torch.cuda.empty_cache()
        import io

        from pt_three_ways_tpu_torch import cli as port_cli
        from pt_three_ways_tpu_torch.parallel import distributed, shard
        from pt_three_ways_tpu_torch.parallel.mesh import all_reduce, make_mesh
        from pt_three_ways_tpu_torch.parallel.shard import render_sharded
        from pt_three_ways_tpu_torch.parallel.train import make_sharded_train_step
        from pt_three_ways_tpu_torch.utils import native
        from pt_three_ways_tpu_torch.utils.framebuffer import ArrayOutput, merge

        # (a) the native library: it must build and load here (no fallback)
        if native.load() is None:
            fail(f"the native host library did not build ({native.LIB_PATH})")

        @contextlib.contextmanager
        def no_native(off):
            """PT3_NO_NATIVE set (the Python paths) when off, the library
            loaded anew either way."""
            old = os.environ.pop("PT3_NO_NATIVE", None)
            if off:
                os.environ["PT3_NO_NATIVE"] = "1"
            native._LIB, native._TRIED = None, False
            try:
                yield
            finally:
                os.environ.pop("PT3_NO_NATIVE", None)
                if old is not None:
                    os.environ["PT3_NO_NATIVE"] = old
                native._LIB, native._TRIED = None, False

        def host_build(name):
            """The scene's host build (catalog, builder, pack to tensors):
            the least of two, s on the host's clock, and the scene."""
            best = None
            for _ in range(2):
                t0 = time.time()
                sb = SceneBuilder()
                create_scene(sb, name, RenderParams(width=64, height=64))
                scene = sb.build()
                t = time.time() - t0
                best = t if best is None else min(best, t)
            return best, scene

        builds = []
        for name in ("cornell", "suzanne", "ce", "bbc-owl", "example1", "suzanne-sub3"):
            with no_native(False):
                t_n, s_n = host_build(name)
            with no_native(True):
                t_p, s_p = host_build(name)
            flat = lambda sc: [t for part in sc for t in (part if isinstance(part, tuple)
                                                          else (part,))]
            if not all(torch.equal(a, b) for a, b in zip(flat(s_n), flat(s_p))):
                fail(f"the native scene build of {name} differs from the Python one")
            builds.append(f"{name} ({s_n.num_triangles} triangles) native {t_n * 1e3:.1f} ms, "
                          f"Python {t_p * 1e3:.1f} ms")
        print(f"phase 10 native library {native.LIB_PATH}: host scene builds, the least of "
              f"two on the host's clock, bit-equal either way: " + "; ".join(builds)
              + f" [{smi}]", flush=True)
        raws = [os.path.join(raw_dir, "cornell.raw"), os.path.join(raw_dir, "noise.raw")]
        first = ArrayOutput.load(raws[0])
        noise = ArrayOutput(first.width, first.height)
        noise.sum[:] = np.random.default_rng(10).uniform(size=noise.sum.shape)
        noise.count[:] = 40
        noise.save(raws[1])
        merged = [os.path.join(raw_dir, f"merged_{k}.raw") for k in ("python", "native")]
        t0 = time.time()
        merge([ArrayOutput.load(r) for r in raws]).save(merged[0])
        t_py = time.time() - t0
        t0 = time.time()
        native.raw_merge_native(raws, merged[1])
        t_nat = time.time() - t0
        if open(merged[0], "rb").read() != open(merged[1], "rb").read():
            fail("the native .raw merge differs from the Python merge")
        print(f"phase 10 merge of two {first.width}x{first.height} .raw files (load, add, save; "
              f"host clock): Python {t_py * 1e3:.1f} ms, native {t_nat * 1e3:.1f} ms, bytes "
              f"equal [{smi}]", flush=True)

        # (b) a 1-rank NCCL world: the sharded render and train step against
        # the one-device ones, bit for bit
        distributed.initialize(f"tcp://127.0.0.1:{distributed.free_port()}", 1, 0,
                               device="cuda")
        mesh = make_mesh(n_devices=1)
        for g in (mesh.dp_group, mesh.sp_group, mesh.group):  # NCCL's set-up, untimed
            all_reduce(torch.ones(1, device=dev), g)
        torch.cuda.synchronize()
        backend = torch.distributed.get_backend()

        def hold_main(kernel, call, n_launches):
            """The wrapper call (a, kw) on the card against its plain version,
            as phase 5 holds the main group's call; timed, with its bound."""
            a, kw = call
            pk, state0 = a[0], a[1]
            out_k = wrappers[kernel](*a, **kw)
            with plain(kernel):
                pms, out_p = once_ms(lambda: wrappers[kernel](*a, **kw))
            _, err = cmp_acc(kernel, out_k, out_p)
            if (kernel == "K5" or pk.no_glossy) and not same_out(out_k, out_p):
                fail(f"{kernel} on the sharded render's main launch differs from its plain "
                     "version")
            ms = events_ms(lambda: wrappers[kernel](*a, **kw), 3)
            live = int(out_p[1].sum().item())
            search = [live * full_scan_ops(pk)]
            if pk.n_windows > 1 and pk.n_tri > 0:
                search = [0]
                with plain(kernel), counting_search(search):
                    wrappers[kernel](*a, **kw)
            b, by = bound(nbytes(state0, a[2], pk.tri_tab, pk.sph_tab, pk.tri_attr,
                                 pk.sph_attr) + nbytes(*out_k), search[0] + live * OPS_SHADE)
            return dict(launches=n_launches, max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by)

        for tag in ("cornell-square", "suzanne"):
            scene, camera, params = render_inputs[tag]
            walls = {}
            for way, fn in (("render()", lambda: render(scene, camera, params, device="cuda")),
                            ("render_sharded", lambda: render_sharded(scene, camera, params,
                                                                      mesh))):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.time()
                out = fn()
                torch.cuda.synchronize()
                walls[way] = (time.time() - t0, out, read_counts())
            (w_r, out_r, _), (w_s, out_s, counts10) = walls["render()"], walls["render_sharded"]
            if not (np.array_equal(out_r.sum, out_s.sum)
                    and np.array_equal(out_r.count, out_s.count)):
                fail(f"the 1-rank sharded render of {tag} differs from render()")
            # the sharded render again: every K2 launch checked, the K4/K5 calls kept
            seen, calls = [], {"K4": {}, "K5": {}}
            launch2 = ik._intersect_cuda

            def k2_hook(*a):
                out = launch2(*a)
                seen.append(a if not seen else None)
                k2_check(a)
                return out

            def keep(kernel, name, config):
                f = getattr(mk, name)

                def hook(*a, **kw):
                    calls[kernel].setdefault(config(a, kw), (a, kw))
                    # the launch counter is an attribute of the wrapper itself
                    setattr(mk, name, f)
                    try:
                        return f(*a, **kw)
                    finally:
                        setattr(mk, name, hook)
                return hook

            with swapped(ik, "_intersect_cuda", k2_hook), \
                    swapped(mk, "fused_passes", keep("K5", "fused_passes",
                                                     lambda a, kw: a[5])), \
                    swapped(mk, "fused_passes_krng", keep("K4", "fused_passes_krng",
                                                          lambda a, kw: (a[7], kw.get(
                                                              "tail_frac", 0.0)))):
                render_sharded(scene, camera, params, mesh)
            torch.cuda.synchronize()
            held = []
            if tag == "suzanne":
                k2_report(10, "sharded", scene, seen[0], counts10["K2"], len(seen))
            # K4 and K5 on cornell's render: K5's main call, K4's one call (the
            # probe; suzanne's K4 calls are phase 5's, 25 s a plain run)
            for kernel in ("K4", "K5") if tag == "cornell-square" else ():
                if calls[kernel]:
                    main = list(calls[kernel].values())[-1]
                    checks[kernel]["sharded"] = hold_main(kernel, main, counts10[kernel])
                    c = checks[kernel]["sharded"]
                    held.append(f"{kernel} {'main' if kernel == 'K5' else 'probe'} launch "
                                f"against its plain version max|dacc| "
                                f"{c['max_abs_err']:.3e}, {c['ms']:.3f} ms, plain "
                                f"{c['plain_ms']:.1f} ms, bound {c['bound_ms']:.3f} ms "
                                f"({c['bound_by']})")
            for k in ("K2", "K4") + (("K5",) if tag == "cornell-square" else ()):
                if counts10[k] <= 0:
                    fail(f"kernel {k} was not launched by the sharded {tag} render")
            print(f"phase 10 1-rank {backend} mesh {tag} {params.width}x{params.height} spp "
                  f"{params.samples_per_pixel}: render_sharded {w_s:.3f} s, render() "
                  f"{w_r:.3f} s, sum and count bit-equal; launches {counts10}; every K2 "
                  f"launch ({len(seen)}) bit-equal to its plain version; "
                  + "; ".join(held) + f" [{smi}]", flush=True)
            del walls, out_r, out_s, calls, seen
        torch.cuda.empty_cache()
        # the 1-rank regenerating train step against mesh=None, bit for bit,
        # with PyTorch's deterministic algorithms (which the camera stage's
        # material gather needed while its VJP was an accumulating
        # index_put_; K12 sums in a fixed order); mesh=None runs twice to
        # show that the reference itself repeats bit for bit
        rscene, rcam, rparams = phase10_scene("suzanne", 512, seed=1)
        rin = phase10_train_inputs(rscene, rcam, rparams, 7)
        steps = {}
        import torch.utils.deterministic as det

        fill = det.fill_uninitialized_memory
        det.fill_uninitialized_memory = False  # leave torch.empty as it is
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name, m in (("mesh", mesh), ("one device", None), ("one device again", None)):
                step = make_sharded_train_step(rscene, rparams, m, learning_rate=0.05,
                                               passes_per_step=S_REGEN)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                loss, new = step(rin[3], rng.base_key(7), *rin[:3])
                torch.cuda.synchronize()
                steps[name] = (time.time() - t0, float(loss),
                               [x.detach() for x in new.materials],
                               torch.cuda.max_memory_allocated() / 2**30)
        finally:
            torch.use_deterministic_algorithms(False)
            det.fill_uninitialized_memory = fill
        (w_m, l_m, m_m, p_m), (w_o, l_o, m_o, p_o) = steps["mesh"], steps["one device"]
        same = lambda x, y: x[1] == y[1] and all(torch.equal(a, b) for a, b in zip(x[2], y[2]))
        repeats = same(steps["one device"], steps["one device again"])
        if not same(steps["mesh"], steps["one device"]):
            fail(f"the 1-rank regen train step differs from mesh=None: loss {l_m} vs {l_o} "
                 f"(mesh=None repeats itself bit for bit: {repeats})")
        print(f"phase 10 1-rank {backend} mesh regen train step suzanne 512^2 K=16 depth 5 "
              f"S={S_REGEN} (deterministic algorithms): loss {l_m:.9e} and new materials "
              f"bit-equal to mesh=None (which repeats bit for bit: {repeats}); "
              f"{w_m * 1e3:.1f} ms (mesh) vs {w_o * 1e3:.1f} ms, peak {p_m:.2f} vs {p_o:.2f} "
              f"GiB [{smi}]", flush=True)
        del steps, m_m, m_o, rin
        distributed.shutdown()
        torch.cuda.empty_cache()

        # (c) two ranks sharing the one card over gloo
        t0 = time.time()
        two = distributed.spawn(phase10_ranks, 2, 11, device="cuda:0", backend="gloo",
                                timeout=600)
        t_spawn = time.time() - t0
        lines = []
        for name in ("cornell", "suzanne"):
            scene, camera, params = phase10_scene(name, 256, samples_per_pixel=16, seed=1)
            fixed = params.replace(autotune=False, passes_per_dispatch=8)
            t0 = time.time()
            ref = render(scene, camera, fixed, device="cuda")
            w_ref = time.time() - t0
            s2, c2, w2 = two[f"dp2 {name}"]
            if not np.array_equal(c2, ref.count) or not np.allclose(s2, ref.sum, rtol=1e-6,
                                                                      atol=0.0):
                fail(f"dp=2 {name} differs from render() beyond rtol 1e-6: max rel "
                     f"{np.max(np.abs(s2 - ref.sum) / np.maximum(np.abs(ref.sum), 1e-30))}")
            rel = float(np.max(np.abs(s2 - ref.sum) / np.maximum(np.abs(ref.sum), 1e-30)))
            t0 = time.time()
            ref = render(scene, camera, params, device="cuda")
            w_def = time.time() - t0
            sa, ca, wa, same = two[f"sp2 {name}"]
            blocks = lambda x, c: (x / c[..., None]).reshape(4, 64, 4, 64, 3).mean(axis=(1, 3))
            if not same:
                fail(f"two sp=2 renders of {name} differ")
            if not np.allclose(blocks(sa, ca), blocks(ref.sum, ref.count), rtol=2e-2,
                               atol=2e-3):
                fail(f"the sp=2 {name} render's 4x4 block means differ from render()'s")
            lines.append(f"{name}: dp=2 {w2:.3f} s (max rel {rel:.2e} to render() "
                         f"{w_ref:.3f} s), sp=2 {wa:.3f} s (render() {w_def:.3f} s; bit-equal "
                         f"twice, block means within rtol 2e-2/atol 2e-3)")
        tscene2, tcam2, tparams2 = phase10_scene("suzanne", 256, seed=1)
        tin = phase10_train_inputs(tscene2, tcam2, tparams2, 11)
        step = make_sharded_train_step(tscene2, tparams2, learning_rate=0.05,
                                       passes_per_step=8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        loss1, new1 = step(tin[3], rng.base_key(11), *tin[:3])
        torch.cuda.synchronize()
        w_1, p_1 = time.time() - t0, torch.cuda.max_memory_allocated() / 2**30
        loss2, mats2, w_t = two["train"]
        if not np.isclose(loss2, float(loss1), rtol=1e-5, atol=0.0):
            fail(f"the dp=2 train step's loss {loss2} vs the one-device step's {float(loss1)}")
        worst = {}
        for f, a, b, o in zip(new1.materials._fields, mats2, new1.materials, tin[3].materials):
            b, o = b.cpu().numpy(), o.cpu().numpy()
            tol = 1e-3 if f == "ior" else 1e-4
            scale = max(np.abs(b - o).max(), 1e-6)
            # an update below two float32 spacings of the value is not resolved
            atol = np.maximum(tol * scale, 2 * np.spacing(np.abs(o)))
            d = np.abs((a - o) - (b - o))
            if not (d <= atol).all():
                fail(f"the dp=2 train step's {f} update differs from the one-device step's")
            worst[f] = float((d / atol).max())
        print(f"phase 10 two gloo ranks on one card (collectives staged through host memory; "
              f"spawned and joined in {t_spawn:.1f} s), 256^2 spp 16 K=16 depth 5: "
              + "; ".join(lines) + f"; dp=2 regen train step suzanne 256^2 S=4 per rank: loss "
              f"{loss2:.9e} vs one device S=8 {float(loss1):.9e}, updates within "
              f"{max(worst.values()):.3f} of the gate, {w_t * 1e3:.1f} ms (one device "
              f"{w_1 * 1e3:.1f} ms); peak device memory per rank over its whole run "
              f"{[round(p, 2) for p in two['peaks']]} GiB (the one-device step {p_1:.2f}) [{smi}]",
              flush=True)
        del two, new1, tin

        # (d) the CLI
        err = io.StringIO()
        out_png = os.path.join(raw_dir, "devices2.png")
        with contextlib.redirect_stderr(err):
            rc = port_cli.main(["-w", "64", "-h", "64", "--spp", "1", "--devices", "2",
                                out_png])
        if rc != 1 or "needs 2 CUDA cards" not in err.getvalue():
            fail(f"cli --devices 2 on one card: rc {rc}, {err.getvalue()!r}")
        # the CLI's sharded branch in a 1-rank torchrun-style world (its
        # variables set here): it joins the world, makes the mesh and renders
        # through render_sharded, rank 0 writing; against the plain run
        raw1, raw0 = (os.path.join(raw_dir, f"cli_devices{k}.raw") for k in (1, 0))
        argv = ["-w", "256", "-h", "256", "--spp", "2", "--seed", "1", "--save-every", "0",
                "--raw"]
        world = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(distributed.free_port()))
        meshes, backends = [], []
        sharded_of = shard.render_sharded

        def sharded_seen(*a, **kw):
            meshes.append(a[3])
            backends.append(torch.distributed.get_backend())
            return sharded_of(*a, **kw)

        saved_env = {k: os.environ.get(k) for k in world}
        os.environ.update(world)
        reset_counts()
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    swapped(shard, "render_sharded", sharded_seen):
                rc1 = port_cli.main([*argv, "--devices", "1", raw1])
            torch.cuda.synchronize()
        finally:
            counts_cli = read_counts()
            distributed.shutdown()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        with contextlib.redirect_stdout(io.StringIO()):
            rc0 = port_cli.main([*argv, raw0])
        if rc1 != 0 or len(meshes) != 1 or meshes[0].dp_group is None:
            fail(f"cli --devices 1 in a 1-rank world (rc {rc1}) did not render through "
                 f"render_sharded on a mesh with groups ({meshes})")
        if counts_cli["K2"] <= 0 or counts_cli["K4"] + counts_cli["K5"] <= 0:
            fail(f"the CLI's sharded render launched no K2 or no K4/K5: {counts_cli}")
        if rc0 != 0 or open(raw1, "rb").read() != open(raw0, "rb").read():
            fail(f"the CLI's sharded branch (rc {rc1}) does not write the plain run's "
                 f"(rc {rc0}) .raw")
        print(f"phase 10 CLI: --devices 2 on one card exits 1 ({err.getvalue().strip()}); "
              f"--devices 1 in a 1-rank {backends[0]} world (RANK/WORLD_SIZE/MASTER_* set) "
              f"renders through render_sharded on a {meshes[0].shape} mesh, launches "
              f"{counts_cli}, and rank 0 writes the plain run's .raw byte for byte", flush=True)
        print(f"phase 10: {time.time() - t10:.1f} s", flush=True)

    # one row per kernel: the numbers of the path that carries it (the
    # CLI-default cornell render for K2 and K4, square cornell for K5, the
    # training steps for K7 and K8: K8's numbers are the mean over the four
    # bounces of the first step; the regen training steps for K4's replay
    # mode and K9; the sub3 render's main launch for K6; compaction for K10,
    # the mean over the four bounces of its first pass), and every path's
    # under "by_path"
    head = {"K2": "cornell", "K5": "cornell-square", "K4": "cornell", "K7": "train",
            "K8": "train", "K4r": "regen-train", "K9": "regen-train", "K6": "sub3",
            "K10": "compact", "K11": "cornell", "K12": "train", "K13": "cornell"}
    meta = {
        "K2": ("K2 intersect_packed", "pt_three_ways_tpu_torch/csrc/intersect.cu",
               "pt_three_ways_tpu/ops/pallas_intersect.py:351"),
        "K5": ("K5 fused_passes", "pt_three_ways_tpu_torch/csrc/megakernel.cu",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:1172"),
        "K4": ("K4 fused_passes_krng", "pt_three_ways_tpu_torch/csrc/megakernel.cu",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:1714"),
        "K7": ("K7 fused_bounces", "pt_three_ways_tpu_torch/csrc/fused_bounces.cu",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:883"),
        "K8": ("K8 bounce_bwd_step", "pt_three_ways_tpu_torch/csrc/bounce_bwd.cu",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:2578"),
        "K4r": ("K4 fused_passes_krng replay", "pt_three_ways_tpu_torch/csrc/megakernel.cu",
                "pt_three_ways_tpu/ops/pallas_megakernel.py:1714"),
        "K9": ("K9 regen_replay_bwd", "pt_three_ways_tpu_torch/csrc/regen_replay_bwd.cu",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:2808"),
        "K6": ("K6 fused_passes_krng stream", "pt_three_ways_tpu_torch/csrc/stream_tri.cuh",
               "pt_three_ways_tpu/ops/pallas_megakernel.py:329"),
        "K10": ("K10 bounce_step", "pt_three_ways_tpu_torch/csrc/bounce_step.cu",
                "pt_three_ways_tpu/ops/pallas_megakernel.py:2078"),
        "K11": ("K11 uniforms", "pt_three_ways_tpu_torch/csrc/threefry.cu",
                "pt_three_ways_tpu/ops/rng.py:52 (XLA's jax.random.uniform, no pallas_call)"),
        "K12": ("K12 material_grad", "pt_three_ways_tpu_torch/csrc/material_grad.cu",
                "pt_three_ways_tpu/models/integrator.py:113 (XLA's transpose of "
                "the gather, a scatter-add; no pallas_call)"),
        "K13": ("K13 camera_rays + first_bounce", "pt_three_ways_tpu_torch/csrc/camera_stage.cu",
                "pt_three_ways_tpu/models/integrator.py:435 (XLA's fusion of the camera "
                "stage; no pallas_call)"),
    }
    checks["K11"] = k11_checks
    rows = []
    for k in ("K2", "K5", "K4", "K7", "K8", "K4r", "K9", "K6", "K10", "K11", "K12", "K13"):
        name, source, replaces = meta[k]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         path=head[k], **{"library_ms": None, **checks[k][head[k]]},
                         by_path=checks[k]))

    print(f"total {time.time() - t_start:.1f} s")
    print(f"card: {smi_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
