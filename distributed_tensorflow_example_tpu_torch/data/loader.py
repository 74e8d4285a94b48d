"""ShardedLoader: seeded shuffling, per-process sharding, prefetch (an
adapted copy of ``distributed_tensorflow_example_tpu/data/loader.py``).

Determinism contract: with the same seed the *global* batch sequence is
the same whatever the process count (each process takes its contiguous
slice of every global batch), and it is the reference's batch for batch,
bit for bit. The native C++ loader arrives with slice A3c.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np

Batch = dict[str, np.ndarray]


class ShardedLoader:
    """Iterates equal-length arrays as per-process batch dicts.

    Args:
      arrays: dict of equal-length numpy arrays (leading dim = examples).
      global_batch: total batch size across all processes.
      process_index/num_processes: this process's slice of each batch.
      shuffle: reshuffle each epoch with a seed derived from (seed, epoch),
        the same on every process.
      drop_remainder: keep batches full.
      transform: optional ``transform(batch, epoch, global_indices) ->
        batch``; its randomness must key on (seed, epoch, global index).
    """

    def __init__(self, arrays: Batch, global_batch: int, *,
                 process_index: int = 0, num_processes: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True,
                 transform: Callable[[Batch, int, np.ndarray], Batch]
                 | None = None):
        if global_batch % num_processes:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{num_processes} processes")
        self.arrays = arrays
        self.keys = sorted(arrays)
        self.n = len(arrays[self.keys[0]])
        for k in self.keys:
            if len(arrays[k]) != self.n:
                raise ValueError("array length mismatch")
        self.global_batch = global_batch
        self.local_batch = global_batch // num_processes
        self.process_index = process_index
        self.num_processes = num_processes
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.transform = transform
        self.epoch = 0

    @property
    def steps_per_epoch(self) -> int:
        return (self.n // self.global_batch if self.drop_remainder
                else -(-self.n // self.global_batch))

    def epoch_batches(self, epoch: int | None = None) -> Iterator[Batch]:
        """One epoch of per-process batches."""
        epoch = self.epoch if epoch is None else epoch
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState((self.seed, epoch)).shuffle(idx)
        for b in range(self.steps_per_epoch):
            g0 = b * self.global_batch
            gidx = idx[g0:g0 + self.global_batch]
            if len(gidx) < self.global_batch and self.drop_remainder:
                return
            # this process's contiguous slice of the global batch
            l0 = self.process_index * self.local_batch
            lidx = gidx[l0:l0 + self.local_batch]
            batch = {k: self.arrays[k][lidx] for k in self.keys}
            if self.transform is not None:
                batch = self.transform(batch, epoch, lidx)
            yield batch

    def __iter__(self) -> Iterator[Batch]:
        """Endless batches, advancing epochs."""
        while True:
            yield from self.epoch_batches(self.epoch)
            self.epoch += 1


class PrefetchIterator:
    """Host-side background prefetch: a bounded queue between a producer
    thread and the training loop."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._it = it
        self._done = object()
        self._err: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once the consumer closed the
        iterator, so an abandoned producer never blocks forever."""
        while not self._closed:
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return               # closed: stop producing
        except BaseException as e:   # re-raised in the consumer
            self._err = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Release the producer thread (idempotent); pending batches are
        discarded."""
        self._closed = True
        try:
            while True:
                self._q.get_nowait()     # unblock a producer mid-put
        except queue.Empty:
            pass


def make_loader(arrays: Batch, global_batch: int, *, prefetch: int = 0,
                start_step: int = 0, **kw) -> Iterator[Batch]:
    """A batch iterator (:class:`ShardedLoader`, behind a
    :class:`PrefetchIterator` when ``prefetch > 0``). ``start_step``
    fast-forwards the sequence, so a restored run consumes exactly the
    batches an uninterrupted run would have."""
    loader = ShardedLoader(arrays, global_batch, **kw)
    it = _fast_forward(loader, iter(loader), start_step)
    return PrefetchIterator(it, prefetch) if prefetch > 0 else it


def _fast_forward(loader: ShardedLoader, it: Iterator[Batch],
                  start_step: int) -> Iterator[Batch]:
    if start_step <= 0:
        return it
    spe = loader.steps_per_epoch
    loader.epoch = start_step // spe       # jump whole epochs for free
    for _ in range(start_step % spe):      # discard the epoch prefix
        next(it)
    return it
