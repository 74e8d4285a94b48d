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
``ckpt.commit`` and ``ckpt.read`` fault seams are the reference's.

Sharded mode (``sharded=True``, the reference's format, so either
package restores the other's): instead of gathering every leaf to rank
0, each rank writes the pieces it owns to its own
``ckpt-N.shard-<p>-of-<P>.npz``, with the piece index (each leaf's
dtype, global shape and the start and shape of each piece) as JSON under
``__shardmeta__``; after a barrier rank 0 writes the small
``ckpt-N.shards.json`` anchor and commits it to the ring. A rank owns
its piece of a sharded leaf where it sits at coordinate 0 on every axis
that does not split that leaf (the reference's ``replica_id == 0``
shards: an ``fsdp`` piece's owners have ``data`` and ``model`` at 0, a
``model`` piece's ``data`` and ``fsdp``), so each piece is written once;
rank 0 owns the whole leaves.
Restore reads selectively: a rank reads only its piece of a sharded
leaf when a saved piece has its bounds, and otherwise assembles the leaf
from its pieces and cuts its own (a restore onto another mesh). The
format is detected per step, so a run may switch modes across restarts,
and a same-step save in the other format supersedes the old one.
A sharded state (``TrainState.layout``) saved monolithically is gathered
over ``fsdp`` and ``model`` first, on every rank.
"""

from __future__ import annotations

import glob
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
#: reserved npz key of a shard file: JSON piece index
SHARD_META_KEY = "__shardmeta__"

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
    record, or a sharded checkpoint missing a shard file (same contract
    as the reference's error of this name)."""


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


class _VerifiedNpz:
    """An npz read member by member, each checked against the CRC record
    as it is read: a sharded restore reads only the pieces it needs, and
    every byte it reads is verified. Raises CorruptCheckpointError."""

    def __init__(self, path: str):
        self.path = path
        try:
            self._z = np.load(path, allow_pickle=False)
            self._crcs = (json.loads(bytes(self._z[CRC_KEY]).decode())
                          if CRC_KEY in self._z.files else None)
        except (OSError, ValueError, zipfile.BadZipFile, zlib.error) as e:
            raise CorruptCheckpointError(
                f"unreadable npz {path!r}: {e}") from e
        if self._crcs is not None and set(self._crcs) != set(self.files):
            raise CorruptCheckpointError(
                f"npz {path!r} members do not match its CRC record")

    @property
    def files(self) -> list[str]:
        return [k for k in self._z.files if k != CRC_KEY]

    def __getitem__(self, key: str) -> np.ndarray:
        try:
            v = self._z[key]
        except (OSError, ValueError, zipfile.BadZipFile, zlib.error) as e:
            raise CorruptCheckpointError(
                f"npz {self.path!r} member {key!r} unreadable: {e}") from e
        if self._crcs is not None and crc32_of(v) != self._crcs.get(key):
            raise CorruptCheckpointError(
                f"npz {self.path!r} member {key!r} fails CRC32 "
                "verification")
        return v

    def close(self) -> None:
        self._z.close()


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


def _pieces(state) -> dict[str, str]:
    """{state key: param key} of the leaves that are this rank's pieces
    of a sharded state (its sharded params and their per-parameter
    optimizer leaves); empty for a whole state."""
    layout = getattr(state, "layout", None)
    if layout is None:
        return {}
    pkeys = list(flatten_dict(state.params))
    out = {f"params/{k}": k for k in pkeys if layout.splits[k]}
    keyed = _tree_items(layout.map_per_param(state.opt_state,
                                             lambda k, v: (k, v)),
                        "opt_state", pkeys)
    for key, item in keyed:
        if isinstance(item, tuple) and layout.leaf_shards(*item):
            out[key] = item[0]
    return out


def _whole_leaves(state) -> dict[str, torch.Tensor]:
    """:func:`_state_leaves` with every piece of a sharded state gathered
    over its axis into its whole leaf (a collective: every rank calls
    it)."""
    leaves = _state_leaves(state)
    for key, pkey in _pieces(state).items():
        leaves[key] = state.layout.gather(pkey, leaves[key])
    return leaves


def state_arrays(state) -> dict[str, np.ndarray]:
    """A TrainState as the reference's flat checkpoint arrays (bf16 leaves
    as uint16 under ``__bf16__/``); a sharded state's pieces are gathered
    first, so every rank must call it."""
    out = to_numpy(_whole_leaves(state))
    out["step"] = np.asarray(state.step, np.int32)
    seed = int(state.seed) % 2**64
    out[_KEY_DATA] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    out[_KEY_IMPL] = np.frombuffer(_THREEFRY.encode(), dtype=np.uint8)
    return out


_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


# ---------------------------------------------------------------------------
# sharded mode: pieces and their index (the reference's format)
# ---------------------------------------------------------------------------

def _piece_key(leaf_key: str, start) -> str:
    return leaf_key + "::" + "_".join(str(int(s)) for s in start)


def _host_piece(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor as a host array and its dtype's name (bf16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _owned_pieces(state) -> tuple[dict[str, np.ndarray], dict]:
    """This rank's pieces of a TrainState and their index: ``(pieces,
    meta)``, ``pieces`` by npz key (``<leaf>::<start>``), ``meta`` by
    leaf: kind, dtype, global shape and the (start, shape) of each piece
    written here. A rank owns its piece of a sharded leaf where it sits
    at coordinate 0 on every axis that does not split the leaf
    (``ShardLayout.owns``); rank 0 owns the whole leaves, the step and
    the PRNG key."""
    rank0 = distributed.process_index() == 0
    layout = state.layout
    cut = _pieces(state)
    pieces: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}

    def add(key, arr, dtype, shape, start, kind="array", **extra):
        pk = _piece_key(key, start)
        pieces[pk] = arr
        meta[key] = {"kind": kind, "dtype": dtype, "shape": list(shape),
                     **extra, "pieces": [{"key": pk, "start": list(start),
                                          "shape": list(arr.shape)}]}

    for key, t in _state_leaves(state).items():
        if key in cut:
            if layout.owns(cut[key]):
                arr, dtype = _host_piece(t)
                bounds = layout.bounds(cut[key])
                add(key, arr, dtype, layout.shapes[cut[key]],
                    [a for a, _ in bounds])
        elif rank0:
            arr, dtype = _host_piece(t)
            add(key, arr, dtype, arr.shape, [0] * arr.ndim)
    if rank0:
        add("step", np.asarray(state.step, np.int32), "int32", (), ())
        seed = int(state.seed) % 2**64
        add("rng", np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32),
            "uint32", (2,), (0,), kind="prngkey", impl=_THREEFRY)
    return pieces, meta


def _merge_metas(loads: Mapping[str, "_VerifiedNpz"]) -> dict[str, dict]:
    """Every shard file's piece index merged into one leaf map; each piece
    gains the ``file`` it lives in."""
    merged: dict[str, dict] = {}
    for p, z in loads.items():
        for key, entry in json.loads(bytes(z[SHARD_META_KEY]).decode()
                                     ).items():
            tgt = merged.setdefault(key, {**entry, "pieces": []})
            tgt["pieces"].extend({**pc, "file": p}
                                 for pc in entry["pieces"])
    return merged


def _leaf_from_pieces(key: str, entry: dict,
                      loads: Mapping[str, "_VerifiedNpz"]) -> np.ndarray:
    """A whole leaf assembled from its saved pieces (bf16 as uint16)."""
    shape = tuple(entry["shape"])
    dtype = (np.dtype(np.uint16) if entry["dtype"] == "bfloat16"
             else np.dtype(entry["dtype"]))
    out = np.empty(shape, dtype)
    covered = 0
    for pc in entry["pieces"]:
        sl = tuple(slice(a, a + d) for a, d in zip(pc["start"], pc["shape"]))
        out[sl] = loads[pc["file"]][pc["key"]]
        covered += math.prod(pc["shape"])
    if covered < math.prod(shape):
        raise ValueError(
            f"sharded checkpoint does not cover leaf {key!r} of shape "
            f"{shape}: {covered} elements present — missing shard files?")
    return out


def _wanted(template) -> dict[str, tuple]:
    """{state key: bounds} of a sharded template's pieces."""
    return {k: template.layout.bounds(pk)
            for k, pk in _pieces(template).items()}


def state_from_arrays(template, arrays: Mapping[str, np.ndarray]):
    """``template`` (a TrainState) with every leaf read from ``arrays``
    (reference keys), on the template's devices. Shapes and dtypes must
    match the template's, as in the reference: a checkpoint restores at
    the ``param_dtype`` it was written with. The step and the seed come
    from the checkpoint. A piece of a sharded template is cut from the
    whole leaf at its bounds (an array already cut to them, which a
    sharded restore reads alone, is taken as it is)."""
    pieces = _pieces(template)

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
        if key in pieces:
            layout = template.layout
            if tuple(arr.shape) == layout.shapes[pieces[key]]:
                arr = arr[tuple(slice(a, b)
                                for a, b in layout.bounds(pieces[key]))]
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
        if sharded and async_save and distributed.process_count() > 1:
            # the sharded commit barriers across the ranks after their
            # writes: on the writer thread it would interleave with the
            # training loop's collectives
            raise ValueError(
                "sharded=True with async_save is only supported with one "
                "rank: the commit barrier across ranks cannot run on the "
                "writer thread")
        self.directory = directory
        self.sharded = sharded
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

    def _anchor_exists(self, step: int) -> bool:
        return (os.path.exists(self.checkpoint_path(step))
                or os.path.exists(self.shard_anchor_path(step)))

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
        if self.sharded:
            return self._save_sharded(state, step)
        path = None
        # a sharded state's pieces are gathered on every rank
        arrays = (self._snapshot(state)
                  if self.is_writer or state.layout is not None else None)
        if self.is_writer:
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
        """Delete a rotated-out checkpoint: for a sharded one, its anchor
        and every shard file of its step."""
        m = re.search(rf"{PREFIX}-(\d+)\.shards\.json$", base)
        if m:
            for f in glob.glob(os.path.join(
                    self.directory, f"{PREFIX}-{m.group(1)}.shard-*.npz")):
                os.remove(f)
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
        # a save of this step in the other format supersedes the old one:
        # its anchor (and shard files) go, so a stale ckpt-N.npz cannot
        # shadow a newer ckpt-N.shards.json at restore
        m = re.search(rf"{PREFIX}-(\d+)\.(npz|shards\.json)$", base)
        if m:
            other = (f"{PREFIX}-{m.group(1)}."
                     + ("shards.json" if m.group(2) == "npz" else "npz"))
            if other in st["all_model_checkpoint_paths"]:
                st["all_model_checkpoint_paths"].remove(other)
            if other in st.get("kept_forever", []):
                st["kept_forever"].remove(other)
                was_kept = True      # kept-forever follows the step
            if other == (st.get("best") or {}).get("path"):
                st["best"]["path"] = base
            self._remove_victim(other)
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
            base = os.path.basename(
                self.checkpoint_path(step)
                if os.path.exists(self.checkpoint_path(step))
                else self.shard_anchor_path(step))
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
        if not os.path.exists(self.shard_anchor_path(step)):
            raise FileNotFoundError(
                f"no checkpoint at step {step} under {self.directory!r}")
        for p in self._shard_files(step):
            _read_npz(p, keep=False)

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
            return state_from_arrays(
                template, self.sharded_arrays(step, _wanted(template)))
        raise FileNotFoundError(path)

    # -- sharded mode -----------------------------------------------------
    def _shard_files(self, step: int) -> list[str]:
        """The shard files the anchor of ``step`` names; a missing one is
        a CorruptCheckpointError."""
        anchor = self.shard_anchor_path(step)
        try:
            with open(anchor) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step} anchor {anchor!r} is unreadable "
                f"({type(e).__name__}: {e})") from e
        paths = [os.path.join(self.directory, b) for b in files]
        missing = [os.path.basename(p) for p in paths
                   if not os.path.exists(p)]
        if missing:
            raise CorruptCheckpointError(
                f"sharded checkpoint step {step} is missing shard files "
                f"{missing}: every shard must live on a filesystem every "
                "rank can read")
        return paths

    def _save_sharded(self, state, step: int) -> str:
        """Every rank writes the pieces it owns to its shard file; after a
        barrier rank 0 writes the anchor and commits it (a torn save is
        invisible: restore reads only a committed anchor); the ranks meet
        again so none reads the state file before the commit."""
        pieces, meta = _owned_pieces(state)
        p, nprocs = distributed.process_index(), distributed.process_count()
        base = f"{PREFIX}-{step}.shard-{p}-of-{nprocs}.npz"
        shard_path = os.path.join(self.directory, base)
        os.makedirs(self.directory, exist_ok=True)
        pieces[SHARD_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                               dtype=np.uint8)
        if self._executor is not None and state.anomaly_count.device.type \
                == "cpu":
            pieces = {k: np.array(v, copy=True) for k, v in pieces.items()}

        def write_and_commit() -> str:
            with self._lock, span("checkpoint_write", process="training",
                                  lane="checkpoint_writer", step=step):
                self._atomic_npz(pieces, shard_path)
                distributed.barrier()
                if self.is_writer:
                    anchor = self.shard_anchor_path(step)
                    tmp = anchor + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump({"num_shards": nprocs, "step": step,
                                   "files": [f"{PREFIX}-{step}.shard-{i}-"
                                             f"of-{nprocs}.npz"
                                             for i in range(nprocs)]}, f)
                    os.replace(tmp, anchor)
                    self._commit(os.path.basename(anchor))
                distributed.barrier()
                return shard_path

        if self._executor is not None:       # one rank only (the ctor)
            with self._pending_lock:
                pending, self._pending = self._pending, None
                if pending is not None:
                    pending.result()
                self._pending = self._executor.submit(write_and_commit)
            return shard_path
        return write_and_commit()

    def sharded_arrays(self, step: int,
                       wanted: Mapping[str, tuple] | None = None
                       ) -> dict[str, np.ndarray]:
        """The sharded checkpoint of ``step`` as flat arrays in the
        monolithic layout (``__bf16__/`` keys, the PRNG key). A leaf in
        ``wanted`` ({key: piece bounds}) is read alone when a saved piece
        has exactly those bounds; every other leaf is assembled whole
        from its pieces. Each member read is CRC-checked."""
        loads = {p: _VerifiedNpz(p) for p in self._shard_files(step)}
        try:
            metas = _merge_metas(loads)
            out: dict[str, np.ndarray] = {}
            for key, entry in metas.items():
                by_bounds = {tuple((a, a + d) for a, d in
                                   zip(pc["start"], pc["shape"])): pc
                             for pc in entry["pieces"]}
                want = (wanted or {}).get(key)
                if want is not None and want in by_bounds:
                    pc = by_bounds[want]
                    arr = loads[pc["file"]][pc["key"]]
                else:
                    arr = _leaf_from_pieces(key, entry, loads)
                if entry["kind"] == "prngkey":
                    out[_KEY_DATA] = arr
                    if "impl" in entry:
                        out[_KEY_IMPL] = np.frombuffer(
                            entry["impl"].encode(), dtype=np.uint8)
                elif entry["dtype"] == "bfloat16":
                    out[BF16_PREFIX + key] = arr
                else:
                    out[key] = arr
            return out
        finally:
            for z in loads.values():
                z.close()


def latest_checkpoint(directory: str) -> str | None:
    """Path of the newest checkpoint (``tf.train.latest_checkpoint``
    parity): its ``ckpt-N.npz``, or for a sharded one its
    ``.shards.json`` anchor."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        return None
    single = mgr.checkpoint_path(step)
    return single if os.path.exists(single) else mgr.shard_anchor_path(step)


def _agreed_step(manager: CheckpointManager, local: int | None,
                 what: str) -> int | None:
    """Rank 0's ``local`` step on every rank, each rank checking that it
    can see the chosen checkpoint (the directory must be shared)."""
    step = distributed.broadcast_int(local)
    if step is not None and not manager._anchor_exists(step):
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
    # params, optimizer state, extras and anomaly count, in place: the
    # whole leaves from rank 0, a sharded leaf's pieces along every axis
    # that does not split the leaf, from its owner (coordinate 0 there)
    cut = _pieces(state)
    leaves = _state_leaves(state)
    distributed.broadcast_([v for k, v in leaves.items() if k not in cut])
    if cut:
        from ..parallel import collectives
        layout = state.layout
        for k, pkey in cut.items():
            axes = layout.replica_axes(pkey)
            if axes:
                leaves[k].copy_(collectives.broadcast_one_to_all(
                    leaves[k], axes, src=0, mesh=layout.mesh))
    return state, step is not None
