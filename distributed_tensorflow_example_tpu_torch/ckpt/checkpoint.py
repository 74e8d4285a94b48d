"""npz reader and writer in the reference's checkpoint format
(``distributed_tensorflow_example_tpu/ckpt/checkpoint.py``):

- flat ``/``-joined keys (``layer_0/attn/q/kernel``), as ``_flatten``
  writes them;
- a ``__crc32__`` member holding JSON {key: crc32 of the raw bytes},
  recorded at write (``_with_crcs``) and verified at read;
- bfloat16 arrays stored as their uint16 bit patterns under a
  ``__bf16__/`` key prefix (numpy has no bf16; ``_view_dtype``).

Only numpy and torch are needed: no ``ml_dtypes``. The checkpoint ring,
async writer and restore-or-init arrive with the training slice.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
import zlib
from typing import Mapping

import numpy as np
import torch

from ..utils.pytree import flatten_dict, unflatten_dict

CRC_KEY = "__crc32__"
BF16_PREFIX = "__bf16__/"

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
    arr = np.ascontiguousarray(arr)
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


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read every array of an npz written in the reference format,
    verifying each member against the CRC record (files without one
    load unverified, as in the reference)."""
    try:
        z = np.load(path, allow_pickle=False)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CorruptCheckpointError(f"unreadable npz {path!r}: {e}") from e
    with z:
        files = [k for k in z.files if k != CRC_KEY]
        crcs = (json.loads(bytes(z[CRC_KEY]).decode())
                if CRC_KEY in z.files else None)
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
            out[k] = v
    return out
