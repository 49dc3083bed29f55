"""The (dp, sp) device mesh on ``torch.distributed``: one process per device.

The counterpart of the JAX package's ``parallel/mesh.py``. Its two axes:

  * ``sp`` ("spatial"): pixels/rays sharded across devices, the analogue
    of the reference's tile parallelism (src/oo/Renderer.cpp:143-183);
  * ``dp`` ("data"/sample): independent sample passes of the same pixels
    per device, summed, the analogue of the async full-screen-pass scheme
    (src/oo/Renderer.cpp:93-141) and of the offline raw_to_png merge, since
    (sum, count) accumulation is associative.

Ranks are laid out as the JAX package lays out devices
(``np.asarray(devs).reshape(dp, sp)``): ``rank = dp_idx * sp + sp_idx``.
Paths are independent, so the only communication is the framebuffer (and
gradient) sum over ``dp`` and the gathers over ``sp``. A collective whose
group runs on ``gloo`` is staged through host memory when its tensor lies
on a card (gloo's collectives are host collectives).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's view of a (dp, sp) mesh. ``dp_idx``/``sp_idx`` are
    None on a rank outside the mesh; the groups are None without a
    ``torch.distributed`` world (a one-device mesh, whose collectives are
    the identity)."""

    shape: dict  # {"dp": dp, "sp": sp}
    rank: int
    device: torch.device
    dp_idx: Optional[int]
    sp_idx: Optional[int]
    dp_group: object = None  # the ranks holding this rank's pixels
    sp_group: object = None  # the ranks of this rank's sample replica
    group: object = None  # the whole mesh

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"]

    @property
    def member(self) -> bool:
        return self.dp_idx is not None


def one_device_mesh(device) -> Mesh:
    """The 1x1 mesh of this process alone, whatever its world: no groups,
    so its collectives are the identity."""
    return Mesh(shape={"dp": 1, "sp": 1}, rank=0, device=torch.device(device), dp_idx=0,
                sp_idx=0)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device="cuda") -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` ranks of the world
    (default: all of it; without a world, the one process). ``dp`` defaults
    to 1 (every device shards pixels); it must divide the device count.

    Every rank of the world must call this, members or not, in the same
    order: each subgroup is created by every rank. ``device``: this rank's
    device ("cuda" is the card ``distributed.initialize`` set current)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = n_devices or world
    dp = dp or 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide device count {n}")
    if n > world:
        raise ValueError(f"{n} devices requested, but the world has {world} process(es): "
                         "one process per device")
    sp = n // dp
    member = rank < n
    dp_idx, sp_idx = (rank // sp, rank % sp) if member else (None, None)
    groups = {}
    if initialized:
        # new_group is collective over the world: every rank makes every group
        for d in range(dp):
            g = dist.new_group([d * sp + s for s in range(sp)])
            if d == dp_idx:
                groups["sp_group"] = g
        for s in range(sp):
            g = dist.new_group([d * sp + s for d in range(dp)])
            if s == sp_idx:
                groups["dp_group"] = g
        g = dist.new_group(list(range(n)))
        if member:
            groups["group"] = g
    return Mesh(shape={"dp": dp, "sp": sp}, rank=rank, device=torch.device(device),
                dp_idx=dp_idx, sp_idx=sp_idx, **groups)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``t`` over ``group`` (a new tensor; ``t`` itself when
    there is no group)."""
    if group is None:
        return t
    out = t.detach().cpu() if _staged(group, t) else t.detach()
    out = out.clone(memory_format=torch.contiguous_format)  # NCCL needs it dense
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along dim 0, in group
    rank order (the mesh's index order)."""
    if group is None:
        return t
    src = t.detach().cpu() if _staged(group, t) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
