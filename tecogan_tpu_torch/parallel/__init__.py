"""Data parallelism over ``torch.distributed`` (port of
``tecogan_tpu/parallel/``). Row-sharded single-stream inference, the JAX
package's ``sp`` mesh, is ``models/networks/frnet_sp.py``; the batch
sharded over its ``dp`` mesh is ``streams.infer_streams``."""

from .dist import (all_reduce_mean, allgather_object, average_gradients,
                   barrier, broadcast_module, free_port, init_distributed,
                   is_main, launched, local_rank, rank, rank_device,
                   shard_rows, shutdown, spawn, world)

__all__ = ["all_reduce_mean", "allgather_object", "average_gradients",
           "barrier", "broadcast_module", "free_port", "infer_streams",
           "init_distributed", "is_main", "launched", "local_rank", "rank",
           "rank_device", "shard_rows", "shutdown", "spawn", "world"]


def __getattr__(name):
    # imported on first use: ``streams`` imports the networks, which import
    # ``nn``, which imports ``dist`` from this package
    if name == "infer_streams":
        from .streams import infer_streams

        return infer_streams
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
