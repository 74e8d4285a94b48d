"""Warm start: initialize part of a fresh model from a checkpoint (port of
``distributed_tensorflow_example_tpu/ckpt/warm_start.py``).

``tf.train.init_from_checkpoint``'s contract over the reference's npz
checkpoints: unlike ``CheckpointManager.restore`` (resume: the exact
state, step and optimizer included), warm start touches only the
parameters the assignment map selects. The step stays 0 and the
optimizer state fresh, a model path with no checkpoint value keeps its
fresh init, a shape mismatch and a map scope that matches no checkpoint
key are hard errors, and PRNG-key leaves are never transplanted. A checkpoint written by
either package warm-starts the port: its ``params/`` leaves are read by
their flat keys, bf16 leaves from their ``__bf16__/`` uint16 form.

A sharded checkpoint (a ``ckpt-N.shards.json`` anchor and its shard
files, written by either package) warm-starts too: each leaf is
assembled whole from its pieces.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch

from ..utils.pytree import flatten_dict, unflatten_dict
from .checkpoint import (BF16_PREFIX, PREFIX, STATE_FILE, CheckpointManager,
                         _tensor, load_npz)

#: npz key prefixes warm start never reads (random streams, shard index)
_SKIPPED = ("__prngkey__/", "__prngimpl__/", "__shardmeta__")


def _checkpoint_path(ckpt: str) -> str:
    if os.path.isfile(ckpt):
        return ckpt
    state_file = os.path.join(ckpt, STATE_FILE)
    if not os.path.exists(state_file):
        raise FileNotFoundError(
            f"{ckpt!r} is no checkpoint file and holds no '{STATE_FILE}' "
            "state file")
    with open(state_file) as f:
        latest = json.load(f).get("latest")
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt!r}")
    return os.path.join(ckpt, latest)


def load_checkpoint_arrays(ckpt: str) -> dict[str, np.ndarray | torch.Tensor]:
    """Flat {key: array} of a checkpoint: a ``ckpt-N.npz`` file or a
    checkpoint directory (the step its state file names latest). Every
    member is CRC-checked. A bf16 leaf comes back as a bf16 CPU tensor
    (numpy has no bf16), the others as numpy arrays; PRNG-key leaves are
    left out."""
    path = _checkpoint_path(ckpt)
    m = re.search(rf"{PREFIX}-(\d+)\.shards\.json$", path)
    if m:
        # the anchor's directory holds its shard files
        arrays = CheckpointManager(os.path.dirname(path)).sharded_arrays(
            int(m.group(1)))
    else:
        arrays = load_npz(path)
    out: dict = {}
    for key, arr in arrays.items():
        if key.startswith(_SKIPPED):
            continue
        if key.startswith(BF16_PREFIX):
            out[key[len(BF16_PREFIX):]] = _tensor(arr, "cpu", True)
        else:
            out[key] = arr
    return out


@dataclasses.dataclass
class WarmStartReport:
    """What the map matched: ``restored`` params came from the
    checkpoint, ``fresh`` kept their init (no checkpoint key)."""

    restored: list[str]
    fresh: list[str]

    def __str__(self) -> str:
        return (f"warm-start: {len(self.restored)} restored, "
                f"{len(self.fresh)} fresh")


def warm_start(params: dict, ckpt: str,
               assignment_map: dict[str, str] | None = None
               ) -> tuple[dict, WarmStartReport]:
    """``params`` (a fresh init) with the leaves the map selects replaced
    by ``ckpt``'s values, cast to each leaf's dtype on its device.

    ``assignment_map`` maps checkpoint scopes to model scopes as
    ``tf.train.init_from_checkpoint`` does: ``{"encoder/": "enc/"}``
    loads checkpoint key ``encoder/X`` into model path ``enc/X``; the
    default ``{"": ""}`` matches identical paths. Entries apply
    independently, in order: the first that resolves to a checkpoint key
    wins. A path with no checkpoint value keeps its fresh value; a shape
    mismatch, or a map scope that matches no checkpoint key (a typo would
    leave every mapped path fresh), is a ValueError."""
    if assignment_map is None:
        assignment_map = {"": ""}
    arrays = load_checkpoint_arrays(ckpt)
    available = {k[len("params/"):]: v for k, v in arrays.items()
                 if k.startswith("params/")}
    if not available:
        raise ValueError(
            f"checkpoint {ckpt!r} holds no 'params' leaves "
            f"(keys: {sorted(arrays)[:8]}...)")
    for ck_prefix in assignment_map:
        if not any(k.startswith(ck_prefix) for k in available):
            raise ValueError(
                f"warm start: assignment-map checkpoint scope {ck_prefix!r} "
                f"matches no checkpoint key (have e.g. "
                f"{sorted(available)[:5]}...)")

    def lookup(path: str):
        for ck_prefix, model_prefix in assignment_map.items():
            if path.startswith(model_prefix):
                key = ck_prefix + path[len(model_prefix):]
                if key in available:
                    return available[key]
        return None

    restored: list[str] = []
    fresh: list[str] = []
    out = {}
    for path, leaf in flatten_dict(params).items():
        value = lookup(path)
        if value is None:
            fresh.append(path)
            out[path] = leaf
            continue
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(
                f"warm start: shape mismatch for {path!r}: checkpoint "
                f"{tuple(value.shape)} vs model {tuple(leaf.shape)}")
        restored.append(path)
        value = torch.as_tensor(np.ascontiguousarray(value)
                                if isinstance(value, np.ndarray) else value)
        out[path] = value.to(device=leaf.device, dtype=leaf.dtype)
    return unflatten_dict(out), WarmStartReport(restored=restored,
                                                fresh=fresh)


def parse_assignment_map(spec: str) -> dict[str, str] | None:
    """The CLI form: ``ckpt_prefix:model_prefix`` pairs, comma-separated
    (``bert/encoder/:encoder/``); an empty string -> None (identity)."""
    spec = spec.strip()
    if not spec:
        return None
    out: dict[str, str] = {}
    for pair in spec.split(","):
        if ":" not in pair:
            raise ValueError(
                f"bad --warm_start_map entry {pair!r} "
                "(want ckpt_prefix:model_prefix)")
        ck, model = pair.split(":", 1)
        if not re.fullmatch(r"[\w/.\-]*", ck + model):
            raise ValueError(f"bad --warm_start_map entry {pair!r}")
        out[ck] = model
    return out
