"""Import TensorFlow-era checkpoints, the source's ``model.ckpt`` (an
adapted copy of ``distributed_tensorflow_example_tpu/ckpt/tf_import.py``).

The source's Saver wrote graph-variable checkpoints
(``model.ckpt-N.{index,data-*}`` and a ``checkpoint`` state file). A user
migrating from it has those files; this module reads them into the
port's parameter trees (nested dicts of tensors), so training resumes, or
evaluation runs, from the old weights.

TensorFlow is an optional dependency, imported only inside
:func:`load_tf_checkpoint`: the port never imports it on a training path.
Only the checkpoint reader is used: no graph, no session.

Usage::

    from distributed_tensorflow_example_tpu_torch.ckpt import tf_import
    arrays = tf_import.load_tf_checkpoint("/old/run/model.ckpt-2000")
    params = tf_import.import_into(
        template_params, arrays, mapping=tf_import.mnist_mlp_mapping(arrays))

``mapping`` is ``{tree path: tf variable name}`` with ``/``-joined tree
paths (``fc1/kernel``, the checkpoints' keys). :func:`mnist_mlp_mapping`
detects the two variable-naming styles the source's genre used for the
2-layer MNIST MLP.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

PyTree = Any


def load_tf_checkpoint(prefix: str) -> dict[str, np.ndarray]:
    """Every variable of a TF checkpoint as host arrays.

    ``prefix`` is the checkpoint prefix (``.../model.ckpt-2000``, the path
    without its ``.index``/``.data-*`` suffix), or a directory holding a
    ``checkpoint`` state file (its latest checkpoint is read).
    """
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "importing TF checkpoints needs the tensorflow package (this "
            "offline migration tool only; the port does not depend on "
            "TensorFlow)") from e
    if os.path.isdir(prefix):
        latest = tf.train.latest_checkpoint(prefix)
        if latest is None:
            raise FileNotFoundError(
                f"no TF checkpoint state under {prefix!r}")
        prefix = latest
    reader = tf.train.load_checkpoint(prefix)
    shapes = reader.get_variable_to_shape_map()
    return {name: np.asarray(reader.get_tensor(name))
            for name in shapes
            # bookkeeping tensors, not model variables
            if not name.startswith("_CHECKPOINTABLE_OBJECT_GRAPH")}


def _map_with_path(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and
    tuples, paths ``/``-joined (list positions as their index), each
    container keeping its type."""
    if isinstance(tree, Mapping):
        out = {k: _map_with_path(fn, v, f"{prefix}{k}/")
               for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(out)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def import_into(template: PyTree, arrays: Mapping[str, np.ndarray],
                mapping: Mapping[str, str], *,
                allow_missing: bool = False) -> PyTree:
    """Place TF variables into a parameter tree per ``mapping``.

    Every mapped leaf is shape-checked against the template and takes the
    template leaf's dtype and device; unmapped template leaves keep their
    values (fresh init), so a partial import (say, the backbone only) is
    explicit in the mapping. A mapped TF name missing from ``arrays``
    raises unless ``allow_missing``; a mapping key that names no template
    path always raises.
    """
    matched: set[str] = set()

    def place(key: str, tleaf):
        tf_name = mapping.get(key)
        if tf_name is None:
            return tleaf
        matched.add(key)
        if tf_name not in arrays:
            if allow_missing:
                return tleaf
            raise KeyError(
                f"mapping sends {key!r} to TF variable {tf_name!r}, which "
                f"the checkpoint does not contain (has: "
                f"{sorted(arrays)[:8]}...)")
        arr = np.asarray(arrays[tf_name])
        tshape = tuple(getattr(tleaf, "shape", arr.shape))
        if tuple(arr.shape) != tshape:
            raise ValueError(
                f"TF variable {tf_name!r} shape {arr.shape} != template "
                f"leaf {key!r} shape {tshape}")
        if isinstance(tleaf, torch.Tensor):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(
                device=tleaf.device, dtype=tleaf.dtype)
        if hasattr(tleaf, "dtype"):
            return arr.astype(tleaf.dtype, copy=False)
        return arr

    out = _map_with_path(place, template)
    unconsumed = set(mapping) - matched
    if unconsumed:
        # a key that matches no template path would leave fresh weights in
        # place: the trained-from-random failure a migration must not allow
        raise KeyError(
            f"mapping keys {sorted(unconsumed)} match no path in the "
            f"template tree (template paths are '/'-joined, e.g. "
            f"'fc1/kernel'; pass the PARAMS tree, not a TrainState)")
    return out


def mnist_mlp_mapping(arrays: Mapping[str, np.ndarray]
                      ) -> dict[str, str]:
    """Mapping for the source's 2-layer MNIST MLP.

    The example genre used two naming styles:

    - anonymous ``tf.Variable``s: ``Variable`` (W1), ``Variable_1`` (b1),
      ``Variable_2`` (W2), ``Variable_3`` (b2);
    - scoped ``hid_w/sm_w``-style names (the canonical blog example):
      weights named ``*hid_w*``/``*sm_w*``, biases ``*hid_b*``/``*sm_b*``.

    Detection is by name first, falling back to the chained shapes (two
    rank-2 weights, the first's output dim the second's input dim, and
    their rank-1 biases).
    """
    names = sorted(arrays)

    def find(*subs):
        for n in names:
            if any(s in n for s in subs):
                return n
        return None

    w1 = find("hid_w", "h1/weights", "fc1/kernel", "dense/kernel")
    b1 = find("hid_b", "h1/biases", "fc1/bias", "dense/bias")
    w2 = find("sm_w", "out/weights", "fc2/kernel", "dense_1/kernel")
    b2 = find("sm_b", "out/biases", "fc2/bias", "dense_1/bias")
    if not all((w1, b1, w2, b2)):
        # anonymous-Variable style: the layers by their chained dims (w1's
        # output dim is w2's input dim), whatever the width
        ws = [n for n in names if arrays[n].ndim == 2]
        bs = [n for n in names if arrays[n].ndim == 1]
        if len(ws) == 2 and len(bs) == 2:
            a, b = ws
            if arrays[a].shape[1] == arrays[b].shape[0]:
                w1, w2 = a, b
            elif arrays[b].shape[1] == arrays[a].shape[0]:
                w1, w2 = b, a
            if w1 is not None:
                # bias dims match the weights' output dims
                bs.sort(key=lambda n: (arrays[n].shape[0]
                                       != arrays[w1].shape[1]))
                b1, b2 = bs
    if not all((w1, b1, w2, b2)):
        raise ValueError(
            f"cannot identify the 2-layer MLP variables among {names}")
    return {"fc1/kernel": w1, "fc1/bias": b1,
            "fc2/kernel": w2, "fc2/bias": b2}
