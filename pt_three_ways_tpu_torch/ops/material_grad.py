"""K12: the material gather's VJP, the table's gradient summed by material id.

``models/integrator.gather_materials`` loads every material field at each
lane's id. Where the table is differentiated, the VJP of those loads sums
each lane's nine cotangents (emission 3, diffuse 3, ior, reflectivity, cone
angle) into the row of its material. On a CUDA device that is one K12 call
(``csrc/material_grad.cu``: per-warp sums, block partials, a second pass
in a fixed order; no float atomics, so the same inputs give bit-identical
gradients); on the CPU its plain version, a lane-order ``index_add_``.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import _cuda

K12_BLOCK = 256  # threads a block (kBlock in material_grad.cu)
K12_LANES = 4  # lanes a thread, at the least, before the grid is capped
K12_MAX_BLOCKS = 1024
_DTYPES = {torch.float32: 0, torch.float64: 1}


def k12_blocks(n: int) -> int:
    """K12's grid, a function of the lane count alone: the summation order,
    and so every bit of the result, is the same on every card."""
    return max(1, min(-(-n // (K12_BLOCK * K12_LANES)), K12_MAX_BLOCKS))


def material_grad_plain(ids: torch.Tensor, cot: torch.Tensor, n_mat: int) -> torch.Tensor:
    """Plain version of K12: ``cot``'s columns added into the rows of their
    ids in lane order -> [n_mat, 9] in ``cot``'s dtype."""
    out = torch.zeros((n_mat, 9), dtype=cot.dtype, device=cot.device)
    return out.index_add_(0, ids.long(), cot.T)


def _material_grad_cuda(ids: torch.Tensor, cot: torch.Tensor, n_mat: int) -> torch.Tensor:
    n = ids.shape[0]
    blocks = k12_blocks(n)
    partial = torch.empty((9 * n_mat, blocks), dtype=cot.dtype, device=cot.device)
    out = torch.empty((n_mat, 9), dtype=cot.dtype, device=cot.device)
    err = _cuda.lib().pt3_material_grad(ids.data_ptr(), cot.data_ptr(), n, n_mat, blocks,
                                        partial.data_ptr(), out.data_ptr(), _DTYPES[cot.dtype],
                                        _cuda.stream_ptr(cot.device))
    _cuda.check(err, "pt3_material_grad")
    material_grad.launches += 1
    return out


@tracing.spanned("pt3.k12", device=True)
def material_grad(ids: torch.Tensor, cot: torch.Tensor, n_mat: int) -> torch.Tensor:
    """K12: ids [N] int32 (every id in [0, n_mat)), cot [9, N] float32 or
    float64, both contiguous on one device -> the table's gradient
    [n_mat, 9] (emission 3, diffuse 3, ior, reflectivity, cone angle) in
    ``cot``'s dtype. K12 on a CUDA device, the plain version on the CPU."""
    n = ids.shape[0]
    if ids.dim() != 1 or cot.shape != (9, n) or n_mat < 1:
        raise ValueError("material_grad: ids [N], cot [9, N], n_mat >= 1")
    if ids.dtype != torch.int32 or cot.dtype not in _DTYPES:
        raise ValueError("material_grad: int32 ids, float32 or float64 cotangents")
    if ids.device != cot.device or not (ids.is_contiguous() and cot.is_contiguous()):
        raise ValueError("material_grad: contiguous ids and cotangents on one device")
    if cot.device.type == "cuda":
        return _material_grad_cuda(ids, cot, n_mat)
    return material_grad_plain(ids, cot, n_mat)


material_grad.launches = 0
