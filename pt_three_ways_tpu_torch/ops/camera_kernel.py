"""K13: the render's camera stage on the card, two kernels beside K2 and K11.

``models/integrator._first_bounce_state`` is the camera stage of one sample
pass: the camera rays, their first hits and the K-fold first bounce. Where
nothing in it is differentiated (``integrator.uses_camera_kernel``) a card
runs it as five launches and no read by the host: K11 draws the camera
uniforms, ``camera_rays`` (K13a) makes the rays, K2 searches, K11 draws the
first bounce's uniforms, and ``first_bounce`` (K13b) shades the winners and
writes the ten state rows of every lane (``csrc/camera_stage.cu``). Their
plain version is the eager stage itself, which the CPU, float64 and every
differentiated stage run, and whose rows K13 gives bit for bit.

Each wrapper counts its launches (``.launches``) and is a device span
``pt3.k13`` of ``utils/tracing``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing
from . import _cuda


def _on(dev, *ts, what: str):
    for t in ts:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: contiguous float32 tensors on {dev}")


def _recip32(n: int) -> float:
    """float32(1) / n in float32: how PyTorch divides a tensor by a Python
    number on the card."""
    return float(np.float32(1.0) / np.float32(n))


@tracing.spanned("pt3.k13", device=True)
def camera_rays(camera, px: torch.Tensor, py: torch.Tensor, unif: torch.Tensor):
    """K13a: ``ops/camera.generate_rays`` for pixels ``px``, ``py`` [R] with
    the camera uniforms ``unif`` [4, R] -> (origins [3, R], directions
    [3, R]), float32 on the card. The camera's fields are read on the
    device: lens or pinhole is chosen per thread by ``aperture > 0``."""
    r = px.shape[0]
    dev = px.device
    if dev.type != "cuda" or py.shape != (r,) or unif.shape != (4, r):
        raise ValueError("camera_rays: px, py [R] and unif [4, R] on a CUDA device")
    _on(dev, unif, *camera, what="camera_rays")
    return _camera_rays_cuda(camera, px, py, unif)


def _camera_rays_cuda(camera, px, py, unif):
    r = px.shape[0]
    dev = px.device
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    rays = torch.empty((2, 3, r), dtype=torch.float32, device=dev)
    err = _cuda.lib().pt3_camera_rays(px.data_ptr(), py.data_ptr(), unif.data_ptr(),
                                      *(f.data_ptr() for f in camera), rays[0].data_ptr(),
                                      rays[1].data_ptr(), r, _cuda.stream_ptr(dev))
    _cuda.check(err, "pt3_camera_rays")
    camera_rays.launches += 1
    return rays[0], rays[1]


camera_rays.launches = 0


@tracing.spanned("pt3.k13", device=True)
def first_bounce(packed, org, dirn, t, idx, fb_u, nv: int, state, base, accumulate: bool,
                 no_glossy: bool, kill_dead: bool):
    """K13b: the first bounce of R pixels' K = ``fb_u.shape[2]`` lanes from
    K2's winners ``t``, ``idx`` [R] of the rays ``org``, ``dirn`` [3, R],
    the first bounce's uniforms ``fb_u`` [3, R, K] (K = nu * nv) and the
    attribute rows of ``packed`` (a ``PackedSceneFused``: its geometry and
    materials are the scene's). Writes the state rows org3 dir3 beta3
    alive1 into ``state`` [10, R*K] (a stage's rows of a launch's state0
    may be passed) and the base colour (emission where hit, else the
    environment) into ``base`` [3, R], or adds it there with
    ``accumulate``. ``no_glossy``: no material of the pack is glossy (the
    cone sample is the mirror direction); ``kill_dead``: the
    zero-throughput kill."""
    r, k = idx.shape[0], fb_u.shape[2]
    n = r * k
    dev = org.device
    if dev.type != "cuda" or not hasattr(packed, "tri_attr"):
        raise ValueError("first_bounce: CUDA tensors and a PackedSceneFused")
    if (org.shape != (3, r) or dirn.shape != (3, r) or t.shape != (r,)
            or fb_u.shape != (3, r, k) or state.shape != (10, n) or base.shape != (3, r)
            or k % nv):
        raise ValueError("first_bounce: org, dirn [3, R], t, idx [R], fb_u [3, R, K], "
                         "state [10, R*K], base [3, R], K a multiple of nv")
    if idx.dtype != torch.int32 or idx.device != dev or not idx.is_contiguous():
        raise ValueError("first_bounce: idx int32, contiguous, on the rays' device")
    _on(dev, org, dirn, t, fb_u, state, base, packed.tri_attr, packed.sph_attr, packed.mat9,
        what="first_bounce")
    _first_bounce_cuda(packed, org, dirn, t, idx, fb_u, nv, state, base, accumulate,
                       no_glossy, kill_dead)


def _first_bounce_cuda(packed, org, dirn, t, idx, fb_u, nv, state, base, accumulate,
                       no_glossy, kill_dead):
    r, k = idx.shape[0], fb_u.shape[2]
    dev = org.device
    env = packed.env_host
    err = _cuda.lib().pt3_first_bounce(
        packed.tri_attr.data_ptr(), packed.sph_attr.data_ptr(), packed.mat9.data_ptr(),
        packed.n_tri, packed.n_sph, env[0], env[1], env[2], org.data_ptr(), dirn.data_ptr(),
        t.data_ptr(), idx.data_ptr(), fb_u.data_ptr(), r, k, nv, _recip32(k // nv),
        _recip32(nv), state.data_ptr(), base.data_ptr(), int(accumulate), int(no_glossy),
        int(kill_dead), _cuda.stream_ptr(dev))
    _cuda.check(err, "pt3_first_bounce")
    first_bounce.launches += 1


first_bounce.launches = 0
