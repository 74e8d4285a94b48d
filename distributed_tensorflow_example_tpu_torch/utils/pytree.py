"""Flat-key helpers: nested parameter dicts <-> ``/``-joined keys, the
same 'a/b/0/c' rendering the reference's checkpoints and sharding rules
use (``utils/pytree.py`` ``path_str``)."""

from __future__ import annotations

from typing import Any, Mapping


def flatten_dict(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """{'a': {'b': x}} -> {'a/b': x}; leaves are anything not a Mapping."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: Mapping[str, Any]) -> dict[str, Any]:
    """{'a/b': x} -> {'a': {'b': x}} (inverse of :func:`flatten_dict`)."""
    out: dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} nests under a leaf")
        if leaf in node:
            raise ValueError(f"duplicate key {key!r}")
        node[leaf] = v
    return out
