"""Data parallelism over ``torch.distributed`` (port of
``tecogan_tpu/parallel/``). Row-sharded single-stream inference, the JAX
package's ``sp`` mesh, is ``models/networks/frnet_sp.py``."""

from .dist import (all_reduce_mean, allgather_object, average_gradients,
                   barrier, broadcast_module, free_port, init_distributed,
                   is_main, launched, local_rank, rank, rank_device,
                   shard_rows, shutdown, spawn, world)

__all__ = ["all_reduce_mean", "allgather_object", "average_gradients",
           "barrier", "broadcast_module", "free_port", "init_distributed",
           "is_main", "launched", "local_rank", "rank", "rank_device",
           "shard_rows", "shutdown", "spawn", "world"]
