"""ctypes bindings of the C++ native loader (an adapted copy of
``distributed_tensorflow_example_tpu/data/native.py``).

The library (``data/_native/dataloader.cpp``, the port's own copy) does
the byte-level work in C++ threads off the GIL: IDX and CIFAR parsing,
CRC-32C and TFRecord indexing, row gather and batch assembly into a
prefetch ring. Python keeps the determinism contract: each epoch's order
comes from the same ``np.random.RandomState((seed, epoch))`` permutation
and the same per-process slice as :class:`~.loader.ShardedLoader`, so both
loaders yield the same batch sequence bit for bit.

The library is built on first use with ``g++`` (``$CXX`` when set) into
``build/native/`` at the repository root, under a file lock so that
concurrent processes build it once, and rebuilt when the source is newer.
:func:`available` is False when it cannot be built or loaded (the
TFRecord readers then take their Python paths); :func:`require` raises
with the compiler's message, and an explicit ``--native`` goes through it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "dataloader.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "native")
_SO = os.path.join(_BUILD_DIR, "libdtxdata.so")
_ABI = 3
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall")

_lib = None
_lib_lock = threading.Lock()
#: why the library is unavailable in this process (None: not yet tried,
#: or loaded)
_error: str | None = None


def _make() -> None:
    """Compile the library, serialized across processes by a lock file: a
    second process waits and then finds it built. The compiler writes a
    temporary file that replaces the library in one rename, so no process
    loads a half-written one. Raises RuntimeError with the compiler's
    output."""
    import fcntl
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not _needs_build():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX") or "g++", *CXXFLAGS, _SRC, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building the native loader failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(
                f"building the native loader failed ({' '.join(cmd)}, exit "
                f"{res.returncode}):\n{res.stderr.strip()}")
        os.replace(tmp, _SO)


def _needs_build() -> bool:
    """The Makefile's rule (missing, or older than its source), decided
    without dlopen: a stale library once loaded cannot be replaced in the
    process."""
    return (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC))


def _bind(lib: ctypes.CDLL) -> None:
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_void_p), c_i64p,
                              ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int]
    lib.dl_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.dl_acquire.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_void_p)]
    lib.dl_release.argtypes = [ctypes.c_void_p]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    for f in ("dl_idx_image_dims", "dl_idx_read_images",
              "dl_idx_label_count", "dl_idx_read_labels",
              "dl_cifar_record_count", "dl_cifar_read"):
        getattr(lib, f).restype = ctypes.c_int
    # int64 sizes are declared: ctypes' default int conversion would
    # truncate payloads of 2 GiB and more
    lib.dl_idx_image_dims.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.dl_idx_read_images.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int64]
    lib.dl_idx_label_count.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.dl_idx_read_labels.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int64]
    lib.dl_cifar_record_count.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.dl_cifar_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64]
    lib.dl_crc32c.restype = ctypes.c_uint32
    lib.dl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.dl_tfrecord_index.restype = ctypes.c_int64
    lib.dl_tfrecord_index.argtypes = [ctypes.c_char_p, c_i64p, c_i64p,
                                      ctypes.c_int64, ctypes.c_int]


def _load() -> ctypes.CDLL | None:
    """The library, built first when needed; None (and :data:`_error`)
    when it cannot be built or loaded. One attempt a process."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if _needs_build():
                _make()
            lib = ctypes.CDLL(_SO)
            abi = lib.dl_abi_version()
            if abi != _ABI:
                raise RuntimeError(f"{_SO}: dl_abi_version() is {abi}, "
                                   f"want {_ABI}")
            _bind(lib)
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> ctypes.CDLL:
    """The library, or RuntimeError saying why it cannot be built or
    loaded (the compiler's message included)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_error}")
    return lib


# ---------------------------------------------------------------------------
# Native format parsers (the same arrays as the numpy readers)
# ---------------------------------------------------------------------------

def _void(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def read_idx_images(path: str) -> np.ndarray:
    """[n, rows, cols] uint8 from a plain IDX image file."""
    lib = require()
    dims = (ctypes.c_int64 * 3)()
    rc = lib.dl_idx_image_dims(path.encode(), dims)
    if rc:
        raise ValueError(f"dl_idx_image_dims({path!r}) -> {rc}")
    n, r, c = dims[0], dims[1], dims[2]
    out = np.empty(n * r * c, np.uint8)
    rc = lib.dl_idx_read_images(path.encode(), _void(out), out.size)
    if rc:
        raise ValueError(f"dl_idx_read_images({path!r}) -> {rc}")
    return out.reshape(n, r, c)


def read_idx_labels(path: str) -> np.ndarray:
    """[n] uint8 from a plain IDX label file."""
    lib = require()
    n = ctypes.c_int64()
    rc = lib.dl_idx_label_count(path.encode(), ctypes.byref(n))
    if rc:
        raise ValueError(f"dl_idx_label_count({path!r}) -> {rc}")
    out = np.empty(n.value, np.uint8)
    rc = lib.dl_idx_read_labels(path.encode(), _void(out), out.size)
    if rc:
        raise ValueError(f"dl_idx_read_labels({path!r}) -> {rc}")
    return out


def read_cifar_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(NHWC f32 [n, 32, 32, 3] in [0, 1], int32 labels), parsed in C++:
    the numpy reader's arrays, byte for byte."""
    lib = require()
    n = ctypes.c_int64()
    rc = lib.dl_cifar_record_count(path.encode(), ctypes.byref(n))
    if rc:
        raise ValueError(f"dl_cifar_record_count({path!r}) -> {rc}")
    x = np.empty((n.value, 32, 32, 3), np.float32)
    y = np.empty(n.value, np.int32)
    rc = lib.dl_cifar_read(path.encode(), _void(x), _void(y), n.value)
    if rc:
        raise ValueError(f"dl_cifar_read({path!r}) -> {rc}")
    return x, y


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) by the C++ slicing-by-8 loop."""
    return int(require().dl_crc32c(data, len(data)))


def tfrecord_index(path: str, *, verify: bool = False
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(data_offsets, data_lengths) int64 arrays of a TFRecord file,
    scanned in C++; ``verify`` also checks both CRCs of every record.
    GZIP shards are refused: their bytes are no record offsets."""
    from .tfrecord import is_gzipped
    if is_gzipped(path):
        raise ValueError(
            f"{path} is GZIP-compressed: offset indexing needs raw "
            "byte offsets; decompress the shard or use "
            "tfrecord_iterator (sequential)")
    lib = require()
    n = lib.dl_tfrecord_index(path.encode(), None, None, 0,
                              1 if verify else 0)
    if n < 0:
        raise ValueError(f"dl_tfrecord_index({path!r}) -> {n}")
    offsets = np.empty(n, np.int64)
    lengths = np.empty(n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.dl_tfrecord_index(path.encode(), offsets.ctypes.data_as(i64p),
                               lengths.ctypes.data_as(i64p), n,
                               1 if verify else 0)
    if rc < 0:
        raise ValueError(f"dl_tfrecord_index({path!r}) -> {rc}")
    return offsets[:rc], lengths[:rc]


# ---------------------------------------------------------------------------
# Native batch loader (ShardedLoader-compatible iteration)
# ---------------------------------------------------------------------------

#: batches in the C++ ring, and the threads that fill it (the reference's
#: defaults)
DEPTH, WORKERS = 4, 2


class NativeLoader:
    """Threaded C++ batch assembly with the :class:`~.loader.ShardedLoader`
    contract: the same batch sequence as ``ShardedLoader(arrays,
    global_batch, process_index=, num_processes=, shuffle=, seed=,
    microbatches=)``, always ``drop_remainder``. The order is numpy's; the
    gather runs in :data:`WORKERS` C++ threads into a ring of
    :data:`DEPTH` batches.
    """

    def __init__(self, arrays: dict[str, np.ndarray], global_batch: int, *,
                 process_index: int = 0, num_processes: int = 1,
                 shuffle: bool = True, seed: int = 0, microbatches: int = 1):
        lib = require()
        if global_batch % (num_processes * microbatches):
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{num_processes} processes x {microbatches} microbatches")
        self._lib = lib
        self.keys = sorted(arrays)   # fixed key order = array order in C++
        if not self.keys:
            raise ValueError("empty batch layout")
        # the C++ side borrows these buffers: keep them alive
        self._arrays = [np.ascontiguousarray(arrays[k]) for k in self.keys]
        self.n = len(self._arrays[0])
        if any(len(a) != self.n for a in self._arrays):
            raise ValueError("array length mismatch")
        if self.n < global_batch:
            raise ValueError(f"{self.n} examples < global_batch "
                             f"{global_batch}")
        self.global_batch = global_batch
        self.local_batch = global_batch // num_processes
        self.process_index = process_index
        self.num_processes = num_processes
        self.shuffle = shuffle
        self.seed = seed
        self.microbatches = microbatches
        self.epoch = 0
        self._rows = [
            max(1, a.dtype.itemsize
                * int(np.prod(a.shape[1:], dtype=np.int64)))
            for a in self._arrays]
        na = len(self._arrays)
        ptrs = (ctypes.c_void_p * na)(*[_void(a).value for a in self._arrays])
        rows = (ctypes.c_int64 * na)(*self._rows)
        self._handle = lib.dl_create(ptrs, rows, na, self.n,
                                     self.local_batch, DEPTH, WORKERS)
        if not self._handle:
            raise RuntimeError("dl_create failed")
        self._batches_left = 0

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.global_batch

    def epoch_order(self, epoch: int) -> np.ndarray:
        """This process's example indices for one epoch, batch after
        batch: :class:`~.loader.ShardedLoader`'s ``lidx`` of each batch,
        concatenated (its slice of each microbatch, in order)."""
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            np.random.RandomState((self.seed, epoch)).shuffle(idx)
        nb = self.steps_per_epoch
        m = self.local_batch // self.microbatches
        g = idx[:nb * self.global_batch].reshape(nb, self.microbatches, -1)
        return np.ascontiguousarray(
            g[:, :, self.process_index * m:(self.process_index + 1) * m]
        ).reshape(-1)

    def _install_epoch(self) -> None:
        local = self.epoch_order(self.epoch)
        rc = self._lib.dl_set_epoch(self._handle, _void(local), local.size)
        if rc:
            raise RuntimeError(f"dl_set_epoch -> {rc}")
        self._batches_left = self.steps_per_epoch
        self.epoch += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        """Endless batches; closing the iterator (the Trainer does at the
        end of a run or a rollback) stops the worker threads."""
        na = len(self._arrays)
        shapes = [(self.local_batch,) + a.shape[1:] for a in self._arrays]
        ptrs = (ctypes.c_void_p * na)()
        try:
            while True:
                if self._batches_left == 0:
                    self._install_epoch()
                rc = self._lib.dl_acquire(self._handle, ptrs)
                if rc:
                    raise RuntimeError(f"dl_acquire -> {rc}")
                # copy out before the release, so the ring's turnover does
                # not depend on how long the consumer holds a batch
                batch = {}
                for i, key in enumerate(self.keys):
                    nbytes = self.local_batch * self._rows[i]
                    batch[key] = np.frombuffer(
                        (ctypes.c_char * nbytes).from_address(ptrs[i]),
                        dtype=self._arrays[i].dtype
                    ).reshape(shapes[i]).copy()
                self._lib.dl_release(self._handle)
                self._batches_left -= 1
                yield batch
        finally:
            self.close()

    def close(self) -> None:
        """Stop and join the worker threads (idempotent)."""
        if getattr(self, "_handle", None):
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
