"""The process group of a data-parallel run (port of
``tecogan_tpu/parallel/mesh.py``).

The JAX package runs data parallelism as one GSPMD program over a ``dp``
mesh: the batch is sharded, the parameters replicated, and XLA inserts the
reductions that make every loss, BatchNorm statistic and the adaptive
vote a mean over the global batch. The port runs one process per device
instead, as the reference does (``codes/utils/dist_utils.py``), and makes
those reductions itself: ``average_gradients`` after each backward,
``nn.batch_norm``'s global statistics, ``all_reduce_mean`` for the vote
and the logs.

Launch contract: torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which ``spawn``
also sets for the workers it starts. Without it a run is one process and
every helper here is a no-op.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "launched", "rank", "world", "local_rank",
           "is_main", "rank_device", "shard_rows", "allgather_object",
           "all_reduce_mean", "average_gradients", "broadcast_module",
           "barrier", "shutdown", "spawn", "free_port"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a collective waits for the slowest rank (rank 0 alone writes
# the checkpoints while the others wait)
_TIMEOUT = datetime.timedelta(minutes=30)


def launched() -> bool:
    """Whether torchrun's environment names a process group."""
    return all(k in os.environ for k in _ENV)


def init_distributed(device: torch.device | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group torchrun's environment names; returns whether
    this process is in one. Idempotent.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU, unless
    ``backend`` names one (gloo takes CUDA tensors for all_reduce and
    broadcast, and runs several ranks on one card, which NCCL refuses).
    Like ``maybe_init_distributed`` (``mesh.py:36-81``), it runs one small
    collective at once, while the ranks are still together, so that ranks
    arriving far apart at the first real collective do not time it out.
    """
    if dist.is_initialized():
        return True
    if not launched():
        return False
    if device is None:
        device = torch.device("cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=_TIMEOUT, **kw)
    probe = torch.zeros(1, device=device if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main() -> bool:
    return rank() == 0


def rank_device(device_ids) -> torch.device:
    """The device this rank binds: the CPU for ``device_ids == []``, else
    ``cuda:device_ids[LOCAL_RANK]`` when several ids are listed (one per
    local rank) and ``cuda:LOCAL_RANK`` when at most one is (torchrun's own
    convention)."""
    if device_ids is not None and len(device_ids) == 0:
        return torch.device("cpu")
    lr = local_rank()
    if device_ids and len(device_ids) > 1:
        if lr >= len(device_ids):
            raise ValueError(f"local rank {lr} has no device in device_ids "
                             f"{list(device_ids)}")
        return torch.device("cuda", device_ids[lr])
    return torch.device("cuda", lr)


def shard_rows(global_batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch over ``world`` ranks: equal
    blocks in rank order. Raises ValueError where the batch does not
    divide, as the JAX package's loaders do (``device_data.py:158-165``)."""
    if global_batch_size % world:
        raise ValueError(
            f"the global batch of {global_batch_size} does not divide over "
            f"{world} ranks (batch_size_per_gpu * world is the global "
            f"batch)")
    b = global_batch_size // world
    return slice(rank * b, (rank + 1) * b)


def allgather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` in one process)."""
    if world() == 1:
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` itself in one process); no
    gradient. Every rank gets the same bits: the collective reduces each
    element once and sends the result to all."""
    if world() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out.div_(world())


def average_gradients(params) -> None:
    """Replace each gradient by its mean over the ranks, in one all-reduce
    of one flat buffer (no-op in one process). Parameters without a
    gradient are skipped; every rank runs the same step, so the set is the
    same on every rank."""
    if world() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat.div_(world())
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (no-op in one
    process), so that replicas start identical whatever each built or
    loaded."""
    if world() == 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for ``MASTER_PORT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(index: int, fn, nprocs: int, port: int, args: tuple) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        shutdown()


def spawn(fn, nprocs: int, *args) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes that carry torchrun's
    environment (rank = process index, a free localhost port), and wait
    for them all; raises if one fails. ``fn`` must be importable by name
    (a module-level function)."""
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(fn, nprocs, free_port(), args), nprocs=nprocs,
             join=True)
