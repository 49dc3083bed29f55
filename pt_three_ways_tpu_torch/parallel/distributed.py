"""Multi-process orchestration on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``. The
reference's "multi-node" story is filesystem-level: run the binary k times
with different seeds and merge the ``.raw`` checkpoints offline
(src/main/raw_to_png.cpp). That elastic path stays
(``host_local_checkpoint_path``, ``merge_host_checkpoints``); the SPMD path
is one process per device in a ``torch.distributed`` world, over a global
(dp, sp) mesh (``global_mesh``).

``initialize`` joins a world: from its arguments, or from torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``). The backend is NCCL for the card and gloo for the CPU
unless the caller names one. ``spawn`` starts ``n`` local ranks on a free
127.0.0.1 port.
"""

from __future__ import annotations

import glob
import os
import pickle
import socket
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.framebuffer import ArrayOutput
from . import mesh as _mesh


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device="cuda", local_rank: Optional[int] = None) -> bool:
    """Joins the ``torch.distributed`` world; returns False (a no-op) for a
    single process with no address, as the JAX package does.

    ``device``: "cuda" takes card ``local_rank`` (default ``LOCAL_RANK``,
    else the rank), set before the world is joined; "cuda:K" takes card K
    whatever the rank (ranks sharing one card need gloo: NCCL refuses
    that); "cpu" renders on the host. A rank whose card does not exist
    raises RuntimeError naming the card count."""
    env = os.environ
    world_size = world_size if world_size is not None else int(env.get("WORLD_SIZE") or 1)
    rank = rank if rank is not None else int(env.get("RANK") or 0)
    if init_method is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world_size <= 1:
            return False
        else:
            raise ValueError("a world of more than one process needs init_method or "
                             "MASTER_ADDR and MASTER_PORT")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
        index = dev.index
        if index is None:
            index = local_rank if local_rank is not None else int(env.get("LOCAL_RANK") or rank)
        n_cards = torch.cuda.device_count()
        if index >= n_cards:
            raise RuntimeError(f"rank {rank} needs card {index}, but this machine has "
                               f"{n_cards} card(s): one process per card")
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def shutdown() -> None:
    """Leaves the world joined by ``initialize`` (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, device, backend, threads, out, args):
    torch.set_num_threads(threads)
    initialize(f"tcp://127.0.0.1:{port}", n, rank, backend, device, local_rank=rank)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        shutdown()


def spawn(fn, n: int, *args, device="cuda", backend: Optional[str] = None,
          threads: Optional[int] = None, timeout: Optional[float] = None):
    """Runs ``fn(*args)`` on ``n`` local ranks (``torch.multiprocessing``,
    one process each, joined on a free 127.0.0.1 port) and returns rank
    0's result, which must pickle without a device (numpy or CPU tensors).
    Raises if any rank fails, or TimeoutError (the ranks killed) after
    ``timeout`` seconds. ``fn`` must be importable by reference (a
    module-level function). ``threads``: each rank's intra-op threads
    (default: an equal share of the host's cores)."""
    import torch.multiprocessing as mp

    threads = threads or max(1, (os.cpu_count() or 1) // n)
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pickle")
        ctx = mp.spawn(_rank_main, nprocs=n, join=False,
                       args=(fn, n, free_port(), device, backend, threads, out, args))
        while not ctx.join(timeout=1.0):  # raises when a rank fails
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{n} ranks still running after {timeout} s")
        with open(out, "rb") as f:
            return pickle.load(f)


def global_mesh(dp: int = 1, device="cuda"):
    """The (dp, sp) mesh over every process of the world."""
    return _mesh.make_mesh(dp=dp, device=device)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_checkpoint_path(base: str) -> str:
    """This process's ``.raw`` path, ``<root>.host{rank}<ext>`` in a world
    of more than one process (``base`` otherwise), so every process
    checkpoints on its own and any of them (or the reference's raw_to_png)
    merges them afterwards."""
    rank, world = _world()
    if world <= 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.host{rank}{ext}"


def merge_host_checkpoints(base: str, out_path: str) -> ArrayOutput:
    """Merges every ``<root>.host*<ext>`` checkpoint of ``base`` exactly
    (associative (sum, count) accumulation, ArrayOutput.cpp:48-57) into
    ``out_path``; returns the merge."""
    root, ext = os.path.splitext(base)
    paths = sorted(glob.glob(f"{glob.escape(root)}.host*{ext}")) or [base]
    acc = ArrayOutput.load(paths[0])
    for p in paths[1:]:
        acc += ArrayOutput.load(p)
    acc.save(out_path)
    return acc
