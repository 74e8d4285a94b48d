"""Streaming image pipeline: decode per batch on a thread pool (an
adapted copy of ``distributed_tensorflow_example_tpu/data/streaming.py``).

The eager path (``imagenet.load_imagenet_folder``) decodes a whole split up
front: fine at fine-tune scale, impossible for full ImageNet (150 GB of
f32 pixels). Here:

- a cheap metadata pass indexes ``(path, label)`` pairs, or the record
  offsets of TFRecord shards;
- each batch's images are decoded on a thread pool (PIL releases the GIL
  in its decode and resize) only when the batch is needed;
- ``PrefetchIterator`` double-buffers, so the host decodes batch k+1
  while the card trains on batch k;
- memory is bounded by ``prefetch x batch`` decoded images.

Determinism contract, the ``ShardedLoader``'s (loader.py): a seeded
per-epoch shuffle of the global index, each process taking its contiguous
slice, so the global batch sequence does not depend on the process count
and, with ``augment=False``, equals the eager path's over the same files
bit for bit (both decode through ``imagenet.decode_image``). With
``augment=True`` (random-resized crop + flip) each image's rng keys on
(seed, epoch, global index), so the augmented stream keeps both
properties and replays exactly on resume. A sample that still fails after
the IO retries is skipped and its slot refilled from the batch, up to a
cap an epoch (``MAX_SKIPPED_PER_EPOCH``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from ..runtime import faults
from ..utils.logging import get_logger
from .imagenet import augment_image, decode_image, index_image_folder
from .loader import Batch, PrefetchIterator

log = get_logger("streaming")

#: default cap on samples skipped per epoch by the bad-image policy: a
#: handful of truncated JPEGs in a web-scale corpus is routine; hundreds
#: means the dataset (or the filesystem) is broken and the run must say so
MAX_SKIPPED_PER_EPOCH = 64


def _decode_resilient(pool: ThreadPoolExecutor, indices: np.ndarray,
                      one: Callable[[int], tuple[np.ndarray, int]],
                      *, skip_state: dict, what: str) -> Batch:
    """Decode a batch on the thread pool with the self-healing IO policy:
    each sample gets bounded retry + exponential backoff (transient IO),
    and a sample that still fails (truncated/bad image) is SKIPPED — its
    slot is refilled with another sample from the same batch (keeps the
    batch shape static) — with a logged count capped per epoch
    via ``skip_state`` ({'epoch': int, 'count': int, 'total': int,
    'cap': int}). A batch with no decodable sample at all, or a blown
    cap, still raises: self-healing must not quietly train on garbage.
    """
    def attempt(i):
        try:
            return faults.retry_io(lambda: one(int(i)),
                                   what=f"{what} sample {int(i)}")
        except Exception as e:         # undecodable after retries: skip
            return e

    results = list(pool.map(attempt, indices))
    bad = [k for k, r in enumerate(results) if isinstance(r, Exception)]
    if bad:
        good = [k for k, r in enumerate(results)
                if not isinstance(r, Exception)]
        if not good:
            raise RuntimeError(
                f"{what}: every sample in the batch failed to decode "
                f"(first error: {results[bad[0]]}) — refusing to "
                "fabricate a batch")
        skip_state["count"] += len(bad)
        skip_state["total"] += len(bad)
        if skip_state["count"] > skip_state["cap"]:
            raise RuntimeError(
                f"{what}: {skip_state['count']} samples skipped this "
                f"epoch exceeds the cap {skip_state['cap']} — the "
                "dataset or filesystem is broken, not merely flaky")
        log.warning(
            "%s: skipped %d undecodable sample(s) in one batch, refilled "
            "from batch neighbors (%d skipped this epoch, %d this run): %s",
            what, len(bad), skip_state["count"], skip_state["total"],
            "; ".join(str(results[k])[:120] for k in bad[:3]))
        for n, k in enumerate(bad):
            results[k] = results[good[n % len(good)]]
    return {"x": np.stack([x for x, _ in results]),
            "y": np.asarray([y for _, y in results], np.int32)}


class StreamingImageFolder:
    """Lazily-decoded torchvision-layout image folder.

    Presents the same iteration surface as ``ShardedLoader`` (epoch
    attribute, ``steps_per_epoch``, endless ``__iter__``) so
    ``make_loader``-style fast-forward and the Trainer work unchanged.
    """

    def __init__(self, data_dir: str, split: str = "train", *,
                 image_size: int = 224,
                 max_per_class: int | None = None,
                 global_batch: int = 128,
                 process_index: int = 0, num_processes: int = 1,
                 microbatches: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 decode_threads: int = 8,
                 augment: bool = False,
                 fast_decode: bool = False,
                 max_skipped_per_epoch: int = MAX_SKIPPED_PER_EPOCH):
        if global_batch % (num_processes * microbatches):
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{num_processes} processes x {microbatches} microbatches")
        self.paths, self.labels = index_image_folder(
            data_dir, split, max_per_class=max_per_class)
        # bad-image skip policy bookkeeping (_decode_resilient contract)
        self._skip = {"epoch": 0, "count": 0, "total": 0,
                      "cap": max_skipped_per_epoch}
        self.n = len(self.paths)
        if self.n < global_batch:
            # fail fast: steps_per_epoch=0 would make __iter__ a silent
            # busy-loop and skip() a ZeroDivisionError
            raise ValueError(
                f"split {split!r} has {self.n} images < global_batch "
                f"{global_batch}")
        self.image_size = image_size
        self.global_batch = global_batch
        self.local_batch = global_batch // num_processes
        self.process_index = process_index
        self.num_processes = num_processes
        self.microbatches = microbatches
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.fast_decode = fast_decode
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=max(1, decode_threads))

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.global_batch      # always drop_remainder

    def _decode(self, indices: np.ndarray, epoch: int) -> Batch:
        if self.augment:
            # per-image rng from (seed, epoch, global index): the
            # augmented stream is process-count independent and replays
            # bit-exactly on resume
            def one(i):
                rng = np.random.default_rng([self.seed, epoch, int(i)])
                return (augment_image(self.paths[i], self.image_size, rng,
                                      fast=self.fast_decode),
                        int(self.labels[i]))
        else:
            def one(i):
                return (decode_image(self.paths[i], self.image_size,
                                     fast=self.fast_decode),
                        int(self.labels[i]))
        if self._skip["epoch"] != epoch:     # per-epoch skip-cap window
            self._skip.update(epoch=epoch, count=0)
        return _decode_resilient(self._pool, indices, one,
                                 skip_state=self._skip,
                                 what=f"image folder epoch {epoch}")

    def epoch_batches(self, epoch: int | None = None,
                      start: int = 0) -> Iterator[Batch]:
        epoch = self.epoch if epoch is None else epoch
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState((self.seed, epoch)).shuffle(idx)
        for b in range(start, self.steps_per_epoch):
            g0 = b * self.global_batch
            gidx = idx[g0:g0 + self.global_batch]
            yield self._decode(_local_slice(self, gidx), epoch)

    def skip(self, start_step: int) -> None:
        """Exact-resume fast-forward WITHOUT decoding the skipped batches
        (the eager path's _fast_forward burns a next() per skipped batch;
        here a skipped batch would cost real JPEG decodes)."""
        self.epoch = start_step // self.steps_per_epoch
        self._start_batch = start_step % self.steps_per_epoch

    _start_batch = 0

    def __iter__(self) -> Iterator[Batch]:
        start, self._start_batch = self._start_batch, 0
        while True:
            yield from self.epoch_batches(self.epoch, start=start)
            start = 0
            self.epoch += 1

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class StreamingTFRecordImages:
    """Lazily-decoded image TFRecord shards — the classic
    ``train-00000-of-01024`` ImageNet distribution format: records are
    ``tf.train.Example`` with ``image/encoded`` (JPEG bytes) and
    ``image/class/label``. Same iteration surface and determinism
    contract as :class:`StreamingImageFolder`.

    The startup index pass reads only record OFFSETS (the C++ scanner
    when built — no Python per record, no payload parse); labels arrive
    with each batch's record reads. Random access over the shard set
    gives the same seeded global shuffle as the folder pipeline —
    no shuffle-buffer approximation.
    """

    #: per-thread cap on cached shard handles: with 1024 shards and a
    #: global shuffle every thread would otherwise accumulate a handle
    #: per shard and blow the FD limit mid-epoch
    MAX_OPEN_PER_THREAD = 16

    def __init__(self, data_dir: str, split: str = "train", *,
                 image_size: int = 224,
                 global_batch: int = 128,
                 process_index: int = 0, num_processes: int = 1,
                 microbatches: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 decode_threads: int = 8,
                 augment: bool = False,
                 fast_decode: bool = False,
                 label_offset: int = 0,
                 max_skipped_per_epoch: int = MAX_SKIPPED_PER_EPOCH):
        if global_batch % (num_processes * microbatches):
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{num_processes} processes x {microbatches} microbatches")
        self._skip = {"epoch": 0, "count": 0, "total": 0,
                      "cap": max_skipped_per_epoch}
        from .tfrecord import split_shards
        self.shards = split_shards(data_dir, split)
        if not self.shards:
            raise FileNotFoundError(
                f"no {split} TFRecord shards under {data_dir!r}")
        self._offsets: list[np.ndarray] = []
        self._lengths: list[np.ndarray] = []
        shard_ids = []
        slots = []
        for si, path in enumerate(self.shards):
            offs, lens = _shard_index(path)
            self._offsets.append(offs)
            self._lengths.append(lens)
            shard_ids.append(np.full(len(offs), si, np.int32))
            slots.append(np.arange(len(offs), dtype=np.int64))
        self._shard_of = np.concatenate(shard_ids)
        self._slot_of = np.concatenate(slots)
        self.n = len(self._shard_of)
        if self.n < global_batch:
            raise ValueError(
                f"split {split!r} has {self.n} records < global_batch "
                f"{global_batch}")
        self.image_size = image_size
        self.global_batch = global_batch
        self.local_batch = global_batch // num_processes
        self.process_index = process_index
        self.num_processes = num_processes
        self.microbatches = microbatches
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.fast_decode = fast_decode
        self.label_offset = label_offset
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=max(1, decode_threads))
        import threading
        self._tls = threading.local()     # per-thread LRU of shard handles
        self._open_lock = threading.Lock()
        self._open_files: "list" = []     # all live handles, for close()

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.global_batch

    def _read_record(self, i: int) -> bytes:
        from collections import OrderedDict
        si = int(self._shard_of[i])
        slot = int(self._slot_of[i])
        files = getattr(self._tls, "files", None)
        if files is None:
            files = self._tls.files = OrderedDict()
        f = files.get(si)
        if f is None:
            f = open(self.shards[si], "rb")
            files[si] = f
            with self._open_lock:
                self._open_files.append(f)
            if len(files) > self.MAX_OPEN_PER_THREAD:
                _, victim = files.popitem(last=False)
                with self._open_lock:
                    if victim in self._open_files:
                        self._open_files.remove(victim)
                victim.close()
        else:
            files.move_to_end(si)
        f.seek(int(self._offsets[si][slot]))
        return f.read(int(self._lengths[si][slot]))

    def _example(self, i: int):
        from .tfrecord import decode_example, extract_image_label
        img, label = extract_image_label(
            decode_example(self._read_record(i)))
        return img, label + self.label_offset

    def _decode(self, indices: np.ndarray, epoch: int) -> Batch:
        def one(i):
            img_bytes, label = self._example(int(i))
            if self.augment:
                rng = np.random.default_rng([self.seed, epoch, int(i)])
                x = augment_image(img_bytes, self.image_size, rng,
                                  fast=self.fast_decode)
            else:
                x = decode_image(img_bytes, self.image_size,
                                 fast=self.fast_decode)
            return x, label

        if self._skip["epoch"] != epoch:     # per-epoch skip-cap window
            self._skip.update(epoch=epoch, count=0)
        return _decode_resilient(self._pool, indices, one,
                                 skip_state=self._skip,
                                 what=f"tfrecord stream epoch {epoch}")

    def epoch_batches(self, epoch: int | None = None,
                      start: int = 0) -> Iterator[Batch]:
        epoch = self.epoch if epoch is None else epoch
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState((self.seed, epoch)).shuffle(idx)
        for b in range(start, self.steps_per_epoch):
            g0 = b * self.global_batch
            gidx = idx[g0:g0 + self.global_batch]
            yield self._decode(_local_slice(self, gidx), epoch)

    def skip(self, start_step: int) -> None:
        self.epoch = start_step // self.steps_per_epoch
        self._start_batch = start_step % self.steps_per_epoch

    _start_batch = 0

    def __iter__(self) -> Iterator[Batch]:
        start, self._start_batch = self._start_batch, 0
        while True:
            yield from self.epoch_batches(self.epoch, start=start)
            start = 0
            self.epoch += 1

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        with self._open_lock:
            for f in self._open_files:
                f.close()
            self._open_files.clear()


def _local_slice(src, gidx: np.ndarray) -> np.ndarray:
    """The process's share of a global batch's indices, as
    ``ShardedLoader`` takes it: its contiguous slice of each of the
    ``microbatches`` consecutive microbatches, in order."""
    m = src.local_batch // src.microbatches
    return gidx.reshape(src.microbatches, -1)[
        :, src.process_index * m:(src.process_index + 1) * m].reshape(-1)


def _shard_index(path: str):
    """(data_offsets, data_lengths) for one shard: the C++ scanner when
    built, else a pure-Python header scan — both seek past payloads, so
    indexing cost scales with record count, not dataset bytes."""
    from . import native
    if native.available():
        # gzip-rejecting; verify=True: the one full pass over the
        # bytes is the startup index scan, and the C++ CRC off the GIL
        # makes corruption detection nearly free there
        return native.tfrecord_index(path, verify=True)
    from .tfrecord import index_record_offsets
    return index_record_offsets(path)         # gzip-rejecting


class StreamingSource:
    """Trainer-pluggable data source (duck-typed alternative to the
    batch-keyed numpy dict): the Trainer calls :meth:`make_loader` with its
    sharding coordinates instead of wrapping arrays in a ShardedLoader.

    Backed by an image-folder tree OR TFRecord shards — auto-detected
    from the directory contents (``{split}*.tfrecord`` present wins).
    """

    def __init__(self, data_dir: str, split: str = "train", *,
                 image_size: int = 224, max_per_class: int | None = None,
                 decode_threads: int = 8,
                 augment: bool = False, fast_decode: bool = False,
                 label_offset: int = 0):
        from .tfrecord import split_shards
        self.data_dir = data_dir
        self.split = split
        self.image_size = image_size
        self.max_per_class = max_per_class
        self.decode_threads = decode_threads
        self.augment = augment
        self.fast_decode = fast_decode
        self.label_offset = label_offset
        self.tfrecords = bool(split_shards(data_dir, split))
        self._folder = None    # StreamingImageFolder | StreamingTFRecordImages

    def make_loader(self, global_batch: int, *, start_step: int = 0,
                    process_index: int = 0, num_processes: int = 1,
                    shuffle: bool = True, seed: int = 0,
                    prefetch: int = 2, microbatches: int = 1
                    ) -> Iterator[Batch]:
        if self._folder is not None:      # re-entry: release the previous
            self._folder.close()          # decode pool, don't leak it
        if self.tfrecords:
            if self.max_per_class is not None:
                raise ValueError(
                    "--max_per_class applies to the folder pipeline; "
                    "TFRecord shards carry no class layout to cap")
            self._folder = StreamingTFRecordImages(
                self.data_dir, self.split, image_size=self.image_size,
                global_batch=global_batch,
                process_index=process_index, num_processes=num_processes,
                microbatches=microbatches,
                shuffle=shuffle, seed=seed,
                decode_threads=self.decode_threads,
                augment=self.augment, fast_decode=self.fast_decode,
                label_offset=self.label_offset)
        else:
            if self.label_offset:
                raise ValueError(
                    "label_offset is a TFRecord-shard knob (tf-slim "
                    "1-indexed labels); the folder tree derives labels "
                    "from directory order")
            self._folder = StreamingImageFolder(
                self.data_dir, self.split, image_size=self.image_size,
                max_per_class=self.max_per_class, global_batch=global_batch,
                process_index=process_index, num_processes=num_processes,
                microbatches=microbatches,
                shuffle=shuffle, seed=seed,
                decode_threads=self.decode_threads,
                augment=self.augment, fast_decode=self.fast_decode)
        if start_step > 0:
            self._folder.skip(start_step)
        # same fault seam as make_loader: identity when injection is inert
        it = faults.guard_iterator(iter(self._folder))
        return PrefetchIterator(it, prefetch) if prefetch > 0 else it

    def close(self) -> None:
        if self._folder is not None:
            self._folder.close()
