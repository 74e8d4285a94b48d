"""npz reader and writer in the reference's checkpoint format
(``distributed_tensorflow_example_tpu/ckpt/checkpoint.py``):

- flat ``/``-joined keys (``layer_0/attn/q/kernel``), as ``_flatten``
  writes them;
- a ``__crc32__`` member holding JSON {key: crc32 of the raw bytes},
  recorded at write (``_with_crcs``) and verified at read;
- bfloat16 arrays stored as their uint16 bit patterns under a
  ``__bf16__/`` key prefix (numpy has no bf16; ``_view_dtype``).

Only numpy and torch are needed: no ``ml_dtypes``.

On top of that format, the checkpoint ring (an adapted copy of the
reference's ``CheckpointManager`` and ``restore_or_init``):
``ckpt-N.npz`` files plus a JSON ``checkpoint`` state file naming the
latest and the ring, rotated at ``max_to_keep``, each file written to a
temp file, fsynced and renamed, each array CRC-checked on restore. A
``TrainState`` is flattened to the reference's keys
(:func:`state_arrays`): ``step``, ``params/...``, ``opt_state/...`` by
optax's state positions and field names, ``extras/...``,
``anomaly_count`` and the PRNG key ``rng``, so a directory written by
either package restores in the other.

Under N ranks of a ``torch.distributed`` group (the directory on a
filesystem they share), as in the reference: only rank 0 writes, and
every rank meets the others at a barrier after each save;
``restore_or_init`` takes rank 0's decision (the newest step that
verifies, or a fresh init) on every rank, and rank 0 then broadcasts the
whole state, so every rank starts from the same bits. Async saves (one
writer thread), the ``best`` record (``save_best``, kept out of ring
rotation), rollback's ``discard_steps_above`` and the ``ckpt.write``,
``ckpt.commit`` and ``ckpt.read`` fault seams are the reference's;
sharded saves arrive with slice A6.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import threading
import time
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..obs.trace import span
from ..runtime import distributed, faults
from ..utils.logging import get_logger
from ..utils.pytree import flatten_dict, unflatten_dict

log = get_logger("ckpt")

CRC_KEY = "__crc32__"
BF16_PREFIX = "__bf16__/"
STATE_FILE = "checkpoint"          # the reference's state file name
PREFIX = "ckpt"
#: state leaves a checkpoint may lack (written before they existed):
#: restored as zeros, as in the reference
DEFAULTABLE_LEAVES = ("anomaly_count",)
#: the reference's PRNG-key leaf: the port keeps its dropout seed there,
#: in the layout of a threefry2x32 key ([hi, lo] uint32)
_KEY_DATA, _KEY_IMPL = "__prngkey__/rng", "__prngimpl__/rng"
_THREEFRY = "threefry2x32"
_A6 = "arrive with slice A6"

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


class CorruptCheckpointError(FileNotFoundError):
    """An npz whose members fail their CRC32 or disagree with the CRC
    record (same contract as the reference's error of this name)."""


def crc32_of(arr: np.ndarray) -> int:
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8)) if a.size else 0


def to_numpy(params: Mapping) -> dict[str, np.ndarray]:
    """Nested dict of tensors -> flat {key: np.ndarray} in the reference's
    layout (bf16 leaves as uint16 under ``__bf16__/``)."""
    out: dict[str, np.ndarray] = {}
    for key, t in flatten_dict(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[BF16_PREFIX + key] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            out[key] = t.numpy()
    return out


def _host(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor, sharing memory where numpy allows writes (a
    read-only array, such as a view of a JAX array, is copied)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-d
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _tensor(arr: np.ndarray, device, bf16_bits: bool) -> torch.Tensor:
    if bf16_bits or arr.dtype.name == "bfloat16":   # uint16 or ml_dtypes
        return _host(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype not in _NP_TO_TORCH:
        raise TypeError(f"unsupported array dtype {arr.dtype}")
    return _host(arr).to(device)


def from_numpy(arrays: Mapping[str, np.ndarray], device) -> dict:
    """Flat {key: np.ndarray} (reference layout, ``__bf16__/`` keys or
    numpy bfloat16 arrays) -> nested dict of tensors on ``device``."""
    flat = {}
    for key, arr in arrays.items():
        bf16_bits = key.startswith(BF16_PREFIX)
        if bf16_bits:
            key = key[len(BF16_PREFIX):]
        flat[key] = _tensor(np.asarray(arr), device, bf16_bits)
    return unflatten_dict(flat)


def save_npz(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write ``arrays`` (already flat, reference layout) with the CRC
    record, atomically (temp file + rename)."""
    if CRC_KEY in arrays:
        raise ValueError(f"{CRC_KEY!r} is reserved")
    crcs = {k: crc32_of(np.asarray(v)) for k, v in arrays.items()}
    payload = dict(arrays)
    payload[CRC_KEY] = np.frombuffer(json.dumps(crcs).encode(),
                                     dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _read_npz(path: str, keep: bool) -> dict[str, np.ndarray]:
    """Read every member of an npz in the reference format, one at a time,
    each against the CRC record (files without one read unverified, as in
    the reference); the arrays are returned when ``keep``. Raises
    CorruptCheckpointError."""
    try:
        z = np.load(path, allow_pickle=False)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CorruptCheckpointError(f"unreadable npz {path!r}: {e}") from e
    with z:
        files = [k for k in z.files if k != CRC_KEY]
        try:
            crcs = (json.loads(bytes(z[CRC_KEY]).decode())
                    if CRC_KEY in z.files else None)
        except (OSError, ValueError, zipfile.BadZipFile, zlib.error) as e:
            raise CorruptCheckpointError(
                f"npz {path!r} CRC record unreadable: {e}") from e
        if crcs is not None and set(crcs) != set(files):
            raise CorruptCheckpointError(
                f"npz {path!r} members do not match its CRC record "
                f"(missing {sorted(set(crcs) - set(files))}, unrecorded "
                f"{sorted(set(files) - set(crcs))})")
        out = {}
        for k in files:
            try:
                v = z[k]
            except (OSError, ValueError, zipfile.BadZipFile,
                    zlib.error) as e:
                raise CorruptCheckpointError(
                    f"npz {path!r} member {k!r} unreadable: {e}") from e
            if crcs is not None and crc32_of(v) != crcs[k]:
                raise CorruptCheckpointError(
                    f"npz {path!r} member {k!r} fails CRC32 verification")
            if keep:
                out[k] = v
    return out


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of an npz in the reference format, each verified
    against the CRC record."""
    return _read_npz(path, keep=True)


# ---------------------------------------------------------------------------
# TrainState <-> the reference's flat keys
# ---------------------------------------------------------------------------

def _tree_items(tree, prefix: str, param_keys: list[str]):
    """(key, leaf) pairs of an optimizer state in optax's path layout:
    tuple positions and dict fields name the path; a list holds one
    tensor per parameter (``mu``, ``nu``, ``trace``), named by the
    parameter's key."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}/{k}", param_keys)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}/{i}", param_keys)
    elif isinstance(tree, list):
        if len(tree) != len(param_keys):
            raise ValueError(f"{prefix}: {len(tree)} per-parameter leaves "
                             f"for {len(param_keys)} parameters")
        for k, v in zip(param_keys, tree):
            yield f"{prefix}/{k}", v
    else:
        yield prefix, tree


def _tree_rebuild(tree, prefix: str, param_keys: list[str],
                  leaf: Callable[[str, Any], Any]):
    """``tree`` with every leaf replaced by ``leaf(key, old)``, keys as
    :func:`_tree_items` names them."""
    if isinstance(tree, Mapping):
        out = {k: _tree_rebuild(v, f"{prefix}/{k}", param_keys, leaf)
               for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(out)
    if isinstance(tree, tuple):
        return tuple(_tree_rebuild(v, f"{prefix}/{i}", param_keys, leaf)
                     for i, v in enumerate(tree))
    if isinstance(tree, list):
        return [leaf(f"{prefix}/{k}", v) for k, v in zip(param_keys, tree)]
    return leaf(prefix, tree)


def _state_leaves(state) -> dict[str, torch.Tensor]:
    """Every tensor leaf of a TrainState under its reference key."""
    params = flatten_dict(state.params)
    out = {f"params/{k}": v for k, v in params.items()}
    out.update(_tree_items(state.opt_state, "opt_state", list(params)))
    out.update({f"extras/{k}": v
                for k, v in flatten_dict(state.extras or {}).items()})
    out["anomaly_count"] = state.anomaly_count
    return out


def state_arrays(state) -> dict[str, np.ndarray]:
    """A TrainState as the reference's flat checkpoint arrays (bf16 leaves
    as uint16 under ``__bf16__/``)."""
    out = to_numpy(_state_leaves(state))
    out["step"] = np.asarray(state.step, np.int32)
    seed = int(state.seed) % 2**64
    out[_KEY_DATA] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    out[_KEY_IMPL] = np.frombuffer(_THREEFRY.encode(), dtype=np.uint8)
    return out


_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def state_from_arrays(template, arrays: Mapping[str, np.ndarray]):
    """``template`` (a TrainState) with every leaf read from ``arrays``
    (reference keys), on the template's devices. Shapes and dtypes must
    match the template's, as in the reference: a checkpoint restores at
    the ``param_dtype`` it was written with. The step and the seed come
    from the checkpoint."""

    def leaf(key: str, t: torch.Tensor) -> torch.Tensor:
        bf16 = BF16_PREFIX + key in arrays
        if bf16:
            arr = np.asarray(arrays[BF16_PREFIX + key])
        elif key in arrays:
            arr = np.asarray(arrays[key])
        elif key in DEFAULTABLE_LEAVES:
            return torch.zeros_like(t)
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key!r} shape {arr.shape} != "
                             f"template {tuple(t.shape)}")
        got = "bfloat16" if bf16 else str(arr.dtype)
        want = ("bfloat16" if t.dtype == torch.bfloat16
                else str(_TORCH_TO_NP.get(t.dtype)))
        if got != want:
            raise ValueError(
                f"checkpoint leaf {key!r} dtype {got} != template {want}: "
                "restore with the same param_dtype the checkpoint was "
                "written with")
        return _tensor(arr, t.device, bf16)

    pkeys = list(flatten_dict(template.params))
    params = unflatten_dict({k: leaf(f"params/{k}", v) for k, v in
                             flatten_dict(template.params).items()})
    opt_state = _tree_rebuild(template.opt_state, "opt_state", pkeys, leaf)
    extras = unflatten_dict({k: leaf(f"extras/{k}", v) for k, v in
                             flatten_dict(template.extras or {}).items()})
    if "step" not in arrays:
        raise KeyError("checkpoint missing leaf 'step'")
    seed = template.seed
    if _KEY_DATA in arrays:
        hi, lo = (int(x) for x in np.asarray(arrays[_KEY_DATA]).reshape(-1))
        seed = (hi << 32) | lo
    return template.replace(
        step=int(np.asarray(arrays["step"])), params=params,
        opt_state=opt_state, extras=extras, seed=seed,
        anomaly_count=leaf("anomaly_count", template.anomaly_count))


# ---------------------------------------------------------------------------
# the checkpoint ring
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Write and restore ``ckpt-<step>.npz`` with a ``max_to_keep`` ring
    and the reference's ``checkpoint`` state file (rank 0 is the writer).
    ``keep_every_n_hours`` pins one checkpoint outside the ring every N
    hours, as TF's Saver did; the ``best`` record (:meth:`save_best`)
    survives rotation too.

    With ``async_save`` the host gather stays on the calling thread (every
    leaf copied off the card before ``save`` returns, so the next step
    may run) and one writer thread does the npz write, the CRCs, the
    fsync, the rename and the ring commit. A new save first waits for the
    previous write; a write error surfaces at the next :meth:`save` or
    :meth:`wait` (``close``, ``restore``, ``all_steps``)."""

    def __init__(self, directory: str, *, max_to_keep: int = 5,
                 keep_every_n_hours: float = 0.0, async_save: bool = False,
                 sharded: bool = False):
        if sharded:
            raise NotImplementedError(
                "sharded checkpoints (per-rank shard files) arrive with "
                "slice A6, with the sharded state they write")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_every_n_hours = keep_every_n_hours
        # _lock serializes writes and state-file edits; _pending_lock
        # guards the one pending write's future
        self._lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._pending: Future | None = None
        self._executor = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
            if async_save else None)
        # the keep-forever clock starts now: the first interval must pass
        # before a checkpoint is pinned
        self._last_kept_forever = time.time()
        if self.is_writer:
            os.makedirs(directory, exist_ok=True)

    @property
    def is_writer(self) -> bool:
        return distributed.process_index() == 0

    # -- state file -------------------------------------------------------
    def _state(self) -> dict:
        p = os.path.join(self.directory, STATE_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {"latest": None, "all_model_checkpoint_paths": [],
                "kept_forever": []}

    def _write_state(self, st: dict) -> None:
        p = os.path.join(self.directory, STATE_FILE)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f, indent=1)
        os.replace(tmp, p)

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{PREFIX}-{step}.npz")

    def shard_anchor_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{PREFIX}-{step}.shards.json")

    def all_steps(self) -> list[int]:
        self.wait()                # an async write may not have landed
        st = self._state()
        steps = []
        best = [st["best"]["path"]] if st.get("best") else []
        for p in (st["all_model_checkpoint_paths"]
                  + st.get("kept_forever", []) + best):
            m = re.search(rf"{PREFIX}-(\d+)\.(npz|shards\.json)$", p)
            if m and os.path.exists(os.path.join(self.directory, p)):
                steps.append(int(m.group(1)))
        return sorted(set(steps))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------
    def wait(self) -> None:
        """Block until a pending async write has landed (no-op when none
        is); raises the writer's exception, once."""
        with self._pending_lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        """Drain the writer thread and release it; a pending write error
        surfaces here, after the thread is released."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)

    def _snapshot(self, state) -> dict[str, np.ndarray]:
        """The state as host arrays the writer thread may read while the
        caller trains on: a card's leaves are copied off it here (the copy
        waits for the step that made them); a CPU state's arrays would
        share the tensors' storage, so an async save copies them."""
        arrays = state_arrays(state)
        if self._executor is not None and state.anomaly_count.device.type \
                == "cpu":
            arrays = {k: np.array(v, copy=True) for k, v in arrays.items()}
        return arrays

    def save(self, state, step: int | None = None) -> str | None:
        """Write ``ckpt-<step>.npz`` (default: the state's step), commit it
        to the state file and rotate the ring; every rank then waits at a
        barrier. Returns the path on rank 0, None on the others. With
        ``async_save`` the write is queued behind the previous one (whose
        error, if any, this call raises)."""
        if step is None:
            step = int(state.step)
        path = None
        if self.is_writer:
            arrays = self._snapshot(state)
            if self._executor is not None:
                # drain the previous write (surfacing its error exactly
                # once) and queue this one under one lock hold
                with self._pending_lock:
                    pending, self._pending = self._pending, None
                    if pending is not None:
                        pending.result()
                    self._pending = self._executor.submit(
                        self._write, arrays, step)
                path = self.checkpoint_path(step)
            else:
                path = self._write(arrays, step)
        distributed.barrier()
        return path

    def _write(self, arrays: dict[str, np.ndarray], step: int) -> str:
        """The npz write and the ring commit, on the checkpoint writer's
        trace lane (the caller's thread, or the async writer's)."""
        with self._lock, span("checkpoint_write", process="training",
                              lane="checkpoint_writer", step=step):
            path = self.checkpoint_path(step)
            self._atomic_npz(arrays, path)
            self._commit(os.path.basename(path))
            return path

    def _atomic_npz(self, arrays: dict[str, np.ndarray], path: str) -> None:
        """npz with the CRC record, written to a temp file, fsynced, then
        renamed; the directory is fsynced so the rename persists. The
        ``ckpt.write`` fault seam raises before the write or, with
        ``corrupt=``, damages the landed file."""
        if CRC_KEY in arrays:
            raise ValueError(f"{CRC_KEY!r} is reserved")
        rule = faults.inject("ckpt.write", detail=f"writing {path!r}")
        payload = dict(arrays)
        payload[CRC_KEY] = np.frombuffer(json.dumps(
            {k: crc32_of(np.asarray(v)) for k, v in arrays.items()}
        ).encode(), dtype=np.uint8)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        dirfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        if rule is not None:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                if rule.corrupt == "truncate":
                    f.truncate(max(1, int(size * 0.6)))
                else:                          # zero: overwrite a span
                    f.seek(size // 3)
                    f.write(b"\0" * max(1, size // 3))
            log.warning("fault injected: %s landed file %r damaged",
                        rule.describe(), path)

    def _remove_victim(self, base: str) -> None:
        path = os.path.join(self.directory, base)
        if os.path.exists(path):
            os.remove(path)

    def _commit(self, base: str) -> None:
        """Record ``base`` in the state file and rotate the ring (the
        reference's rules: a step lives in one list, kept-forever stays
        so, the best checkpoint leaves the ring but its file stays). The
        ``ckpt.commit`` fault seam raises before the state file changes,
        so a failed commit leaves the previous ring whole."""
        faults.inject("ckpt.commit", detail=f"committing {base!r}")
        st = self._state()
        now = time.time()
        if base in st["all_model_checkpoint_paths"]:
            st["all_model_checkpoint_paths"].remove(base)
        was_kept = base in st.get("kept_forever", [])
        if was_kept:
            st["kept_forever"].remove(base)
        if was_kept or (self.keep_every_n_hours > 0 and
                        now - self._last_kept_forever
                        >= self.keep_every_n_hours * 3600):
            st.setdefault("kept_forever", []).append(base)
            if not was_kept:
                self._last_kept_forever = now
        else:
            st["all_model_checkpoint_paths"].append(base)
        st["latest"] = base
        while len(st["all_model_checkpoint_paths"]) > self.max_to_keep:
            victim = st["all_model_checkpoint_paths"].pop(0)
            if victim != (st.get("best") or {}).get("path"):
                self._remove_victim(victim)
        self._write_state(st)

    def save_best(self, state, step: int, metric_value: float, *,
                  mode: str = "max") -> bool:
        """Save ``state`` as the new best iff ``metric_value`` improves on
        the recorded best (tf.estimator BestExporter parity); a NaN value
        never does. The best checkpoint survives ring rotation until a
        better one supersedes it; a superseded best no list names is
        deleted. Every rank calls it (rank 0's verdict is broadcast, and
        the save meets at its barrier). Returns True when this step
        became the best."""
        if mode not in ("max", "min"):
            raise ValueError(f"keep_best mode must be max|min, got {mode!r}")
        self.wait()
        value = float(metric_value)
        best = self._state().get("best")
        if math.isnan(value):
            improved = False
        elif best is None or math.isnan(best["value"]):
            improved = True
        else:
            improved = (value > best["value"] if mode == "max"
                        else value < best["value"])
        improved = bool(distributed.broadcast_int(int(improved)))
        if not improved:
            return False
        self.save(state, step)
        if not self.is_writer:
            return True
        self.wait()                      # the async write lands first
        with self._lock:
            st = self._state()
            old = st.get("best")
            base = os.path.basename(self.checkpoint_path(step))
            st["best"] = {"path": base, "step": int(step), "value": value}
            if (old and old["path"] != base
                    and old["path"] not in st["all_model_checkpoint_paths"]
                    and old["path"] not in st.get("kept_forever", [])):
                self._remove_victim(old["path"])
            self._write_state(st)
        return True

    def best_step(self) -> int | None:
        """Step of the best checkpoint (None when none is recorded)."""
        self.wait()
        best = self._state().get("best")
        return int(best["step"]) if best else None

    def discard_steps_above(self, step: int) -> list[int]:
        """Delete every checkpoint newer than ``step`` (rank 0; returns the
        discarded steps): rollback's truncation, so a restart cannot
        resume the trajectory the rollback rejected. The best record is
        cleared when it names a discarded step."""
        if not self.is_writer:
            return []
        self.wait()
        with self._lock:
            st = self._state()
            discarded: list[int] = []

            def keep(base: str) -> bool:
                m = re.search(rf"{PREFIX}-(\d+)\.(npz|shards\.json)$", base)
                if m and int(m.group(1)) > step:
                    discarded.append(int(m.group(1)))
                    self._remove_victim(base)
                    return False
                return True

            st["all_model_checkpoint_paths"] = [
                b for b in st["all_model_checkpoint_paths"] if keep(b)]
            st["kept_forever"] = [b for b in st.get("kept_forever", [])
                                  if keep(b)]
            best = st.get("best")
            if best and int(best.get("step", -1)) > step:
                keep(best["path"])
                st["best"] = None
            if st["latest"] and not os.path.exists(
                    os.path.join(self.directory, st["latest"])):
                remaining = (st["all_model_checkpoint_paths"]
                             + st.get("kept_forever", []))
                st["latest"] = remaining[-1] if remaining else None
            self._write_state(st)
        return sorted(set(discarded))

    # -- integrity --------------------------------------------------------
    def verify_step(self, step: int) -> None:
        """Read every byte of ``step``'s checkpoint against its CRC record.
        Raises CorruptCheckpointError, or FileNotFoundError when nothing
        exists at that step."""
        path = self.checkpoint_path(step)
        if os.path.exists(path):
            _read_npz(path, keep=False)
            return
        if os.path.exists(self.shard_anchor_path(step)):
            raise NotImplementedError(f"sharded checkpoints {_A6}")
        raise FileNotFoundError(
            f"no checkpoint at step {step} under {self.directory!r}")

    def latest_valid_step(self, max_step: int | None = None) -> int | None:
        """Newest step whose checkpoint verifies, walking newest to oldest
        and logging each corrupt one it skips; ``max_step`` bounds the
        walk (rollback restores at or before the last clean step)."""
        steps = self.all_steps()
        if max_step is not None:
            steps = [s for s in steps if s <= max_step]
        for step in reversed(steps):
            try:
                self.verify_step(step)
                return step
            except FileNotFoundError as e:
                log.error("checkpoint step %d failed verification (%s) — "
                          "falling back to the previous checkpoint", step, e)
        return None

    # -- restore ----------------------------------------------------------
    def restore(self, template, step: int | None = None,
                max_step: int | None = None):
        """Load ``step`` (default: the newest that verifies, at or before
        ``max_step``) into the template's structure and devices, after any
        pending async write. With ``step=None`` a corrupt checkpoint is
        logged and the next older one restored; when every candidate is
        corrupt, CorruptCheckpointError. FileNotFoundError when nothing
        exists."""
        self.wait()
        if step is not None:
            return self._restore_step(template, step)
        steps = self.all_steps()
        if max_step is not None:
            steps = [s for s in steps if s <= max_step]
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint under {self.directory!r}"
                + (f" at or before step {max_step}"
                   if max_step is not None else ""))
        last_err: Exception | None = None
        for s in reversed(steps):
            try:
                out = self._restore_step(template, s)
                if last_err is not None:
                    log.error("restored fallback checkpoint step %d (newer "
                              "checkpoint was corrupt: %s)", s, last_err)
                return out
            except CorruptCheckpointError as e:
                log.error("checkpoint step %d corrupt (%s) — falling back "
                          "to the previous checkpoint", s, e)
                last_err = e
        raise CorruptCheckpointError(
            f"every checkpoint under {self.directory!r} (steps {steps}) "
            f"failed verification; last error: {last_err}; no fallback "
            "remains")

    def _restore_step(self, template, step: int):
        faults.inject("ckpt.read", detail=f"restoring step {step}")
        path = self.checkpoint_path(step)
        if os.path.exists(path):
            return state_from_arrays(template, load_npz(path))
        if os.path.exists(self.shard_anchor_path(step)):
            raise NotImplementedError(f"sharded checkpoints {_A6}")
        raise FileNotFoundError(path)


def _agreed_step(manager: CheckpointManager, local: int | None,
                 what: str) -> int | None:
    """Rank 0's ``local`` step on every rank, each rank checking that it
    can see the chosen file (the directory must be shared)."""
    step = distributed.broadcast_int(local)
    if step is not None and not os.path.exists(
            manager.checkpoint_path(step)):
        raise FileNotFoundError(
            f"rank {distributed.process_index()} cannot read {what} "
            f"step {step} that rank 0 chose: the checkpoint directory "
            f"{manager.directory!r} must be a filesystem shared by all "
            "ranks")
    return step


def _agreed_latest_step(manager: CheckpointManager,
                        max_step: int | None = None) -> int | None:
    """Rank 0's newest step that verifies (at or before ``max_step``), on
    every rank. The decision must be one: a rank that restored while
    another initialized would run another loop and hang at the first
    all-reduce."""
    local = (manager.latest_valid_step(max_step) if manager.is_writer
             else None)
    return _agreed_step(manager, local, "checkpoint")


def _agreed_best_step(manager: CheckpointManager) -> int | None:
    """Rank 0's best step, on every rank (the contract of
    :func:`_agreed_latest_step`, for the best record)."""
    return _agreed_step(manager, manager.best_step() if manager.is_writer
                        else None, "best checkpoint")


def restore_or_init(manager: CheckpointManager | None, init_fn, *args,
                    **kwargs):
    """Restore the latest checkpoint when one exists, else ``init_fn``
    (the reference's prepare_session decision). Returns ``(state,
    restored)``. ``restore`` verifies while reading and walks past
    corrupt files; every candidate corrupt raises rather than
    re-initializing over a damaged directory. Under N ranks rank 0
    decides, every rank restores the step it chose, and rank 0's state
    is broadcast."""
    if distributed.process_count() == 1:
        if manager is not None and manager.latest_step() is not None:
            template = init_fn(*args, **kwargs)
            return manager.restore(template, None), True
        return init_fn(*args, **kwargs), False
    step = _agreed_latest_step(manager) if manager is not None else None
    state = init_fn(*args, **kwargs)
    if step is not None:
        state = manager.restore(state, step)
    # params, optimizer state, extras and anomaly count, in place
    distributed.broadcast_(list(_state_leaves(state).values()))
    return state, step is not None
