"""Metrics: a JSONL sink, a TensorBoard event-file sink and rate tracking
(an adapted copy of ``distributed_tensorflow_example_tpu/utils/
metrics.py``).

One JSON object per record, the reference's format; stdout only when no
path is given. With ``tb_logdir`` the same records also go to a
TensorBoard event file (``utils/tb_events.py``): every numeric field of a
record that carries a ``step`` becomes a scalar, one-level-nested dicts
flatten to ``outer/inner`` tags, and a vector field (a list: MoE-BERT's
``expert_load``) stays the JSONL's. Rank 0 writes, as the reference's
process 0 does.
"""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Any, TextIO

import numpy as np

from ..runtime import distributed


class MetricsLogger:
    """Append-only JSONL metrics writer, and optionally a TensorBoard
    event file; rank 0 (the chief) writes, the other ranks' records go
    nowhere. With ``registry`` (``obs.registry.Registry``) it counts the
    JSONL records it writes."""

    def __init__(self, path: str | None = None, *,
                 tb_logdir: str | None = None, registry=None):
        self.path = path
        self._f: TextIO | None = None
        self._tb = None
        self._c_records = (registry.counter(
            "metrics_records_written_total",
            "structured JSONL records written by MetricsLogger")
            if registry is not None else None)
        if distributed.process_index() == 0:
            if path:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                self._f = open(path, "a", buffering=1)
            if tb_logdir:
                from .tb_events import EventFileWriter
                self._tb = EventFileWriter(tb_logdir)

    @staticmethod
    def _flatten_scalars(record: dict[str, Any]) -> dict[str, float]:
        """The record's numeric fields as TensorBoard scalars (``step`` and
        ``time`` aside; a histogram record has none)."""
        out: dict[str, float] = {}
        if "histogram" in record:
            return out
        for k, v in record.items():
            if k in ("step", "time"):
                continue
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    if isinstance(v2, numbers.Number):
                        out[f"{k}/{k2}"] = float(v2)
            elif isinstance(v, numbers.Number):
                out[k] = float(v)
        return out

    def log(self, record: dict[str, Any]) -> None:
        record = dict(record, time=time.time())
        line = json.dumps(record, default=float)
        if self._f is not None:
            self._f.write(line + "\n")
            if self._c_records is not None:
                self._c_records.inc()
        if self._tb is not None and "step" in record:
            scalars = self._flatten_scalars(record)
            if scalars:
                self._tb.scalars(int(record["step"]), scalars,
                                 wall_time=record["time"])

    def log_histogram(self, step: int, tag: str, values) -> None:
        """A distribution: summary stats to the JSONL (non-finite values
        counted, not written), the full HistogramProto to TensorBoard."""
        v = np.asarray(values, np.float64).reshape(-1)
        if v.size == 0:
            return
        fin = v[np.isfinite(v)]
        stats = ({"min": float(fin.min()), "max": float(fin.max()),
                  "mean": float(fin.mean()), "std": float(fin.std())}
                 if fin.size else {})
        self.log({"step": step, "histogram": tag, **stats,
                  "count": int(v.size),
                  "nonfinite": int(v.size - fin.size)})
        if self._tb is not None:
            self._tb.histogram(step, tag, v)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class RateTracker:
    """steps/sec and examples/sec(/chip) over a sliding window; a rank
    drives one card, so the chips are the ranks (the reference's device
    count)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size
        self._t0: float | None = None
        self._s0 = 0

    def start(self, step: int) -> None:
        self._t0 = time.perf_counter()
        self._s0 = step

    def rates(self, step: int) -> dict[str, float]:
        """Rates since the last start(); restarts the window."""
        now = time.perf_counter()
        if self._t0 is None or step <= self._s0:
            self.start(step)
            return {}
        dt = now - self._t0
        steps = step - self._s0
        out = {"steps_per_sec": steps / dt, "sec_per_step": dt / steps}
        if self.batch_size:
            out["examples_per_sec"] = steps * self.batch_size / dt
            out["examples_per_sec_per_chip"] = (
                out["examples_per_sec"] / distributed.process_count())
        self.start(step)
        return out
