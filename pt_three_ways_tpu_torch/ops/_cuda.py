"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each ``.cu`` source is compiled to an object in its own ``nvcc`` process,
all started together, then linked into ``build/torch_kernels/libpt3torch.so``
and loaded with ``ctypes``. The entry points have a plain C interface:
pointers are ``data_ptr()`` integers, the stream is PyTorch's current
stream, and each returns ``cudaGetLastError()`` after its launch. The build
runs at first use and again whenever a source is newer than the library.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` so the kernels round
every product and sum separately, exactly as the plain PyTorch versions
do; division and ``sqrtf`` are IEEE (no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libpt3torch.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
_LOCK = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint
L = ctypes.c_longlong

# entry point -> argument types (all return int: the cudaError_t)
_SIGNATURES = {
    # tri, sph, n_tri, n_sph, t_pad, wbox, wbox1, n_windows, n_groups,
    # window, fan, org, dir, live, t_out, idx_out, n, eps, stream
    "pt3_intersect": [P, P, I, I, I, P, P, I, I, I, I, P, P, P, P, P, I, F, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b,
    # state0, nexta, unif, acc, cnt, next_lane, wbox, wbox1, n_windows,
    # n_groups, window, fan, n, s_count, nb, eps, no_glossy, stream
    "pt3_regen_table": [P, P, P, P, I, I, I, F, F, F,
                        P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b,
    # seed0 seed1 seed2, sample0, lane, amask, state0, resid_in, acc, cnt,
    # resid_out, replay_resid, next_lane, replay_n, tri_win, wbox, wbox1,
    # n_windows, n_groups, window, fan, n, s_count, nb, eps, thresh,
    # no_glossy, block, stream
    "pt3_regen_krng": [P, P, P, P, I, I, I, F, F, F, U, U, U, I,
                       P, P, P, P, P, P, P, P, P, I,
                       P, P, P, I, I, I, I, I, I, I, F, I, I, I, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b, wbox,
    # wbox1, n_windows, n_groups, window, fan, state_in, unif, state_out,
    # cnt, t_out, idx_out, n, eps, no_glossy, stream
    "pt3_bounce_step": [P, P, P, P, I, I, I, F, F, F, P, P, I, I, I, I,
                        P, P, P, P, P, P, I, F, I, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b,
    # org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, wbox, wbox1,
    # n_windows, n_groups, window, fan, n, nb, eps, no_glossy, stream
    "pt3_fused_bounces": [P, P, P, P, I, I, I, F, F, F,
                          P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b,
    # tri_mat, sph_mat, n_mat, state, ts, idxs, unif, cot_out, cot_in,
    # partial, d_out, ticket, n, stream
    "pt3_bounce_bwd": [P, P, P, P, I, I, I, F, F, F,
                       P, P, I, P, P, P, P, P, P, P, P, P, I, P],
    # tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad, env r g b,
    # tri_mat, sph_mat, n_mat, seed0 seed1 seed2, sample0, lane, resid, cnt,
    # acc_bar, d_state0, partial, d_out, n, s_count, stream
    "pt3_regen_replay_bwd": [P, P, P, P, I, I, I, F, F, F, P, P, I, U, U, U, I,
                             P, P, P, P, P, P, P, I, I, P],
    # key word 0, key word 1, n, out, dtype (0 float32, 1 float64), stream
    "pt3_threefry_uniform": [U, U, L, P, I, P],
    # ids, cot, n, n_mat, blocks, partial, out, dtype (0 float32, 1 float64), stream
    "pt3_material_grad": [P, P, I, I, I, P, P, I, P],
    # px, py, unif, the camera's ten fields (centre, axis_x, axis_y, axis_z,
    # aspect, plane_dist, recip_w, recip_h, aperture, focal_dist), org, dir,
    # r, stream
    "pt3_camera_rays": [P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, P],
    # tri_attr, sph_attr, mat9, n_tri, n_sph, env r g b, org, dir, t, idx,
    # fb_u, r, k, nv, inv_nu, inv_nv, state, base, accumulate, no_glossy,
    # kill_dead, stream
    "pt3_first_bounce": [P, P, P, I, I, F, F, F, P, P, P, P, P, I, I, I, F, F, P, P, I, I, I,
                         P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(d) > built for d in deps)


def build(verbose: bool = False) -> str:
    """Compile every source in parallel and link the library. Returns the
    compiler's report (registers, spills) for the log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    objs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        report.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(report))
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", tmp, *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, LIB_PATH)
    text = "\n".join(report)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(text)
    if verbose:
        print(text)
    return text


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if _stale():
                build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr() if t is not None else 0
