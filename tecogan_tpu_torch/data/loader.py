"""Training loader: epoch-shuffled, thread-prefetched host batching (copied
from ``tecogan_tpu/data/loader.py`` lines 1-136).

Replaces torch's DataLoader + DistributedSampler (`codes/data/__init__.py`).
Worker threads assemble clips ahead of the step (the native assembler
releases the GIL inside ctypes); a bounded queue keeps a configurable
number of ready batches.

Determinism: sample i of epoch e uses np.random.Generator seeded with
(seed, e, i): the stream is independent of worker count and scheduling.

Data parallelism: ``batch_size`` is the global batch, as in the JAX
package, whose one process assembles it for the whole mesh. In a run of
``world`` processes rank r assembles only its rows of each global batch,
the block ``[r * b, (r + 1) * b)`` with ``b = batch_size / world``; those
rows are the global batch's rows, bit for bit, since every sample's stream
is keyed by its dataset index.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from ..parallel.dist import shard_rows
from ..utils import tracing

__all__ = ["TrainLoader"]


class TrainLoader:
    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4, drop_last=True,
                 rank: int = 0, world: int = 1):
        self._shard = shard_rows(batch_size, rank, world)
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch_idx: int, start_batch: int = 0):
        """Iterate batches for one epoch (dicts of stacked arrays).

        ``start_batch`` skips the first batches of the epoch WITHOUT
        assembling them (resume path): determinism is untouched because
        each sample's RNG stream is keyed by (seed, epoch, dataset index),
        not by batch position.

        Counters (``utils.tracing``): the producer thread adds each batch
        it builds and its seconds inside it (``loader.assembled``,
        ``loader.assemble_s``); the consumer, once an epoch's first batch
        arrives, the epoch and its seconds from the epoch's start
        (``loader.epoch_starts``, ``loader.epoch_start_wait_s``)."""
        t_start = time.perf_counter()
        n = len(self.dataset)
        order = np.random.default_rng((self.seed, epoch_idx)).permutation(n)
        n_batches = len(self)
        batch_idx = [self._rows(order, i)
                     for i in range(start_batch, n_batches)]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def sample(i):
            rng = np.random.default_rng((self.seed, epoch_idx, int(i)))
            return self.dataset[(int(i), rng)]

        # clip datasets expose (sample_plan, assemble(out=), batch_spec):
        # preallocate each batch and let every worker materialise its
        # sample ONCE, straight into the batch slot (with the native
        # assembler: one fused gather+crop+aug+dtype pass), instead of
        # crop copy + aug copy + np.stack copy per sample
        spec = (self.dataset.batch_spec()
                if n_batches and hasattr(self.dataset, "batch_spec")
                else None)

        def make_batch(pool, idxs):
            if spec is None:
                samples = list(pool.map(sample, idxs))
                return {
                    k: np.stack([s[k] for s in samples])
                    for k in samples[0]
                }
            batch = {k: np.empty((len(idxs),) + tuple(shape), dt)
                     for k, (shape, dt) in spec.items()}

            def one(j_i):
                j, i = j_i
                rng = np.random.default_rng((self.seed, epoch_idx, int(i)))
                plan = self.dataset.sample_plan(int(i), rng)
                self.dataset.assemble(
                    plan, out={k: batch[k][j] for k in batch})

            list(pool.map(one, enumerate(idxs)))  # list(): surface errors
            return batch

        def put_or_stop(item):
            """Blocking put that still observes `stop`: the consumer may
            exit mid-epoch (total_iter reached, exception) with the queue
            full — a plain put would park this thread forever, leaking the
            worker pool and the prefetched batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batch_idx:
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        batch = make_batch(pool, idxs)
                        tracing.add("loader.assemble_s",
                                    time.perf_counter() - t0)
                        tracing.add("loader.assembled", 1)
                        if not put_or_stop(batch):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put_or_stop(e)
            finally:
                # The sentinel MUST be delivered: a full queue here just
                # means the consumer hasn't drained the prefetched batches
                # yet (the common case when the device step is slower than
                # host assembly). put_or_stop waits for space and bails out
                # only if the consumer has already set `stop`.
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                if t_start is not None:
                    tracing.add("loader.epoch_start_wait_s",
                                time.perf_counter() - t_start)
                    tracing.add("loader.epoch_starts", 1)
                    t_start = None
                yield item
        finally:
            stop.set()

    def _rows(self, order, i: int):
        """This rank's dataset indices of global batch ``i`` of ``order``."""
        return order[i * self.batch_size:(i + 1) * self.batch_size][
            self._shard]

    def __iter__(self):
        return self.epoch(0)
